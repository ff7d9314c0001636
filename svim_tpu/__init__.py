"""svim-tpu: an accelerator-native structural-variant calling framework for
long reads.

A from-scratch rebuild of the capability surface of SVIM v2.0.0
(reference: /root/reference, svim/svim:3) designed array-first for an
accelerator (an NVIDIA GPU):

- COLLECT: packed CIGAR/segment tensors -> vectorized JAX kernels
  (reference semantics: svim/SVIM_intra.py, svim/SVIM_inter.py)
- CLUSTER: partition gap-cut + batched span-position/edit-distance matrices
  (JAX) + average-linkage (reference: svim/SVIM_clustering.py)
- COMBINE: BND<->INS merging, POA insertion consensus (native C++)
  (reference: svim/SVIM_COMBINE.py, svim/SVIM_merging.py)
- GENOTYPE: vectorized interval joins over the packed alignment table
  (reference: svim/SVIM_genotyping.py)
- Output: VCF/BED byte-compatible with SVIM (reference: svim/SVCandidate.py)

Scale-out runs over a `jax.sharding.Mesh` (data-parallel read shards,
all-gathered signature tables); see svim_tpu.parallel.
"""

__version__ = "2.0.0"
__all__ = ["__version__"]
