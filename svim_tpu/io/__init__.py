"""Host data plane: FASTA/FASTQ/SAM/BAM readers and device packing.

The reference delegates all of this to pysam/htslib (SVIM_COLLECT.py:11,133).
This package provides a from-scratch implementation: a BGZF/BAM decoder (with
an optional native C++ fast path, svim_tpu/native), a SAM text parser, an
indexed FASTA reader, and packing of alignment records into fixed-width
struct-of-array tensors for the device kernels.
"""

from svim_tpu.io.fasta import FastaFile
from svim_tpu.io.sam import AlignmentFile, AlignmentRecord

__all__ = ["FastaFile", "AlignmentFile", "AlignmentRecord"]
