"""Command-line driver: COLLECT -> CLUSTER -> COMBINE -> GENOTYPE -> output.

Behavioral contract: the reference executable svim/svim:25-217 — logging
setup, mode dispatch, sort-order dispatch, per-stage logging, --all_bnds
handling, output writing and plots.
"""

from __future__ import annotations

import logging
import os
import sys
from time import localtime, strftime

from svim_tpu import __version__
from svim_tpu.cluster import cluster_sv_signatures
from svim_tpu.collect import (
    analyze_alignment_file_coordsorted,
    analyze_alignment_file_querysorted,
)
from svim_tpu.combine import combine_clusters
from svim_tpu.config import guess_file_type, parse_arguments, read_file_list
from svim_tpu.genotype import genotype
from svim_tpu.io.sam import AlignmentFile
from svim_tpu.output import (
    write_candidates,
    write_final_vcf,
    write_signature_clusters_bed,
    write_signature_clusters_vcf,
)
from svim_tpu.plots import write_plots
from svim_tpu.utils.timing import StageTimer


def _device_description():
    try:
        import jax
        return ", ".join(str(device) for device in jax.devices())
    except Exception:
        return "unknown device"


def _process_count():
    from svim_tpu.parallel.multihost import process_count
    return process_count()


def _process_index(options) -> int:
    if not getattr(options, "distributed", False):
        return 0
    from svim_tpu.parallel.multihost import process_index
    return process_index()


def _setup_logging(options):
    log_formatter = logging.Formatter("%(asctime)s [%(levelname)-7.7s]  %(message)s")
    root_logger = logging.getLogger()
    root_logger.setLevel(logging.DEBUG if options.verbose else logging.INFO)
    os.makedirs(options.working_dir, exist_ok=True)
    rank_suffix = ""
    if getattr(options, "distributed", False):
        rank_suffix = ".p{0}".format(_process_index(options))
    file_handler = logging.FileHandler(
        os.path.join(options.working_dir,
                     "SVIM_{0}{1}.log".format(strftime("%y%m%d_%H%M%S", localtime()),
                                              rank_suffix)),
        mode="w")
    file_handler.setFormatter(log_formatter)
    root_logger.addHandler(file_handler)
    console_handler = logging.StreamHandler()
    console_handler.setFormatter(log_formatter)
    root_logger.addHandler(console_handler)
    return root_logger


def _collect(options):
    """Run COLLECT for either mode.  Returns (aln_file, signatures, all_bnds)
    or None on input errors."""
    if options.sub == "reads":
        from svim_tpu.align import run_alignment
        logging.info("MODE: reads")
        logging.info("INPUT: {0}".format(os.path.abspath(options.reads)))
        logging.info("GENOME: {0}".format(os.path.abspath(options.genome)))
        reads_type = guess_file_type(options.reads)
        if reads_type == "unknown":
            return None
        if reads_type == "list":
            use_packed = options.device_backend != "host"
            soa_parts = []
            sv_signatures = []
            translocation_signatures_all_bnds = []
            aln_file = None
            for index, file_path in enumerate(read_file_list(options.reads)):
                logging.info("Starting processing of file {0} from the list..".format(index))
                reads_type = guess_file_type(file_path)
                if reads_type in ("unknown", "list"):
                    return None
                bam_path = run_alignment(options.working_dir, options.genome, file_path,
                                         reads_type, options.cores, options.aligner,
                                         options.nanopore)
                if use_packed:
                    # same array path as the single-file branch, per file;
                    # genotyping uses the LAST file's alignments, matching
                    # the reference's trailing aln_file (svim:73-82)
                    from svim_tpu.collect.packed import collect_soa_from_bam
                    from svim_tpu.io.packed_fetch import PackedAlignmentIndex
                    header, packed, sigs, trans_sigs = collect_soa_from_bam(
                        bam_path, options)
                    aln_file = PackedAlignmentIndex(packed, header)
                    soa_parts.append(sigs)
                else:
                    aln_file = AlignmentFile(bam_path)
                    sigs, trans_sigs = analyze_alignment_file_coordsorted(aln_file, options)
                    sv_signatures.extend(sigs)
                translocation_signatures_all_bnds.extend(trans_sigs)
            if use_packed and soa_parts:
                from svim_tpu.sigtable import concat_soa
                sv_signatures = concat_soa(soa_parts)
            return aln_file, sv_signatures, translocation_signatures_all_bnds
        bam_path = run_alignment(options.working_dir, options.genome, options.reads,
                                 reads_type, options.cores, options.aligner,
                                 options.nanopore)
        if options.device_backend != "host":
            from svim_tpu.collect.packed import collect_soa_from_bam
            from svim_tpu.io.packed_fetch import PackedAlignmentIndex
            header, packed, sigs, trans = collect_soa_from_bam(bam_path, options)
            return PackedAlignmentIndex(packed, header), sigs, trans
        aln_file = AlignmentFile(bam_path)
        sigs, trans = analyze_alignment_file_coordsorted(aln_file, options)
        return aln_file, sigs, trans

    logging.info("MODE: alignment")
    logging.info("INPUT: {0}".format(os.path.abspath(options.bam_file)))
    with open(options.bam_file, "rb") as probe:
        is_bgzf = probe.read(2) == b"\x1f\x8b"
    if options.distributed:
        if not is_bgzf:
            logging.error("--distributed requires a coordinate-sorted BGZF BAM "
                          "input (byte-range ingestion).")
            return None
        from svim_tpu.parallel.multihost import collect_distributed
        merged_index, sigs, trans = collect_distributed(options)
        logging.info("Distributed COLLECT merged {0} signatures across {1} "
                     "processes".format(sigs.total(), _process_count()))
        return merged_index, sigs, trans, options
    if is_bgzf and options.device_backend != "host":
        # cheap sort-order peek, then the packed scanner + device kernels for
        # coordinate-sorted BAM
        from svim_tpu.io.bamstream import peek_bam_header
        try:
            peeked_order = peek_bam_header(options.bam_file).sort_order
        except (ValueError, OSError):
            peeked_order = None
        if peeked_order == "coordinate":
            from svim_tpu.collect.packed import collect_soa_from_bam
            from svim_tpu.io.packed_fetch import PackedAlignmentIndex
            header, packed, sigs, trans = collect_soa_from_bam(
                options.bam_file, options)
            logging.info("Using the packed array COLLECT path on {0}".format(
                _device_description()))
            return PackedAlignmentIndex(packed, header), sigs, trans, options
        # fall through to the sequential reader for non-coordinate inputs

    aln_file = AlignmentFile(options.bam_file)
    try:
        sort_order = aln_file.header["HD"]["SO"]
    except KeyError:
        logging.error("Is the given input BAM file sorted? It does not contain a "
                      "sorting order in its header line.")
        return None
    if sort_order == "coordinate":
        if options.device_backend != "host":
            # SAM text input: records are already parsed; pack them and run
            # the same device kernels as the BAM fast path
            from svim_tpu.collect.packed import collect_signatures_packed
            sigs, trans = collect_signatures_packed(aln_file, options)
        else:
            sigs, trans = analyze_alignment_file_coordsorted(aln_file, options)
    elif sort_order == "queryname":
        if options.device_backend != "host":
            from svim_tpu.collect.packed import collect_signatures_packed_querysorted
            sigs, trans = collect_signatures_packed_querysorted(aln_file, options)
        else:
            sigs, trans = analyze_alignment_file_querysorted(aln_file, options)
        logging.warning("Skipping genotyping because it requires a coordinate-sorted "
                        "input BAM file. The given file is queryname-sorted according "
                        "to its header line.")
        options = options.replace(skip_genotyping=True)
    else:
        logging.error("Input BAM file needs to be coordinate-sorted or "
                      "queryname-sorted. The given file, however, is unsorted "
                      "according to its header line.")
        return None
    return aln_file, sigs, trans, options


def run_pipeline(options):
    """The four-stage pipeline; returns the exit code."""
    root_logger = logging.getLogger()
    trace_requested = getattr(options, "profile_trace", False)
    timer = StageTimer(
        enabled=options.profile or trace_requested,
        trace_dir=(os.path.join(options.working_dir, "traces")
                   if trace_requested else None))
    if trace_requested:
        logging.warning("--profile_trace instruments host threads; traced "
                        "host-bound stage wall times run ~3x their real "
                        "duration. Use --profile alone for timings.")

    logging.info("****************** STEP 1: COLLECT ******************")
    with timer.stage("collect", trace=True):
        result = _collect(options)
    if result is None:
        return 1
    if len(result) == 4:
        aln_file, sv_signatures, translocation_signatures_all_bnds, options = result
    else:
        aln_file, sv_signatures, translocation_signatures_all_bnds = result

    type_names = {
        "DEL": "deleted regions", "INS": "inserted regions",
        "INV": "inverted regions", "DUP_TAN": "tandem duplicated regions",
        "BND": "translocation breakpoints",
        "DUP_INT": "inserted regions with detected region of origin"}
    from svim_tpu.sigtable import SignatureSoA
    if isinstance(sv_signatures, SignatureSoA):
        count_of = sv_signatures.count
    else:
        def count_of(sv_type):
            return sum(1 for sig in sv_signatures if sig.type == sv_type)
    for sv_type in ("DEL", "INS", "INV", "DUP_TAN", "BND"):
        logging.info("Found {0} signatures for {1}.".format(count_of(sv_type),
                                                            type_names[sv_type]))
    if options.all_bnds:
        logging.info("Found {0} signatures for translocation breakpoints from other "
                     "SV classes (DEL, INV, DUP).".format(
                         len(translocation_signatures_all_bnds)))
    logging.info("Found {0} signatures for {1}.".format(count_of("DUP_INT"),
                                                        type_names["DUP_INT"]))

    logging.info("****************** STEP 2: CLUSTER ******************")
    with timer.stage("cluster", trace=True):
        if (getattr(options, "distributed", False) and _process_count() > 1
                and isinstance(sv_signatures, SignatureSoA)):
            # per-partition linkage sharded across ranks; identical global
            # cluster lists come back on every rank (parallel/cluster_shard)
            from svim_tpu.parallel.cluster_shard import (
                cluster_sv_signatures_sharded,
            )
            signature_clusters = cluster_sv_signatures_sharded(sv_signatures,
                                                               options)
        else:
            signature_clusters = cluster_sv_signatures(sv_signatures, options)
        translocation_clusters_all_bnds = None
        if options.all_bnds:
            root_logger.setLevel(logging.WARNING)
            translocation_clusters_all_bnds = cluster_sv_signatures(
                translocation_signatures_all_bnds, options)
            root_logger.setLevel(logging.DEBUG if options.verbose else logging.INFO)

    # in distributed runs every process computes the full pipeline (the
    # stages after the exchange are deterministic); only process 0 writes
    primary = _process_index(options) == 0

    logging.info("Finished clustering. Writing signature clusters..")
    if primary:
        if options.all_bnds:
            all_signature_clusters = signature_clusters[:5] + (
                signature_clusters[5] + translocation_clusters_all_bnds[5],)
            write_signature_clusters_bed(options.working_dir, all_signature_clusters)
            write_signature_clusters_vcf(options.working_dir, all_signature_clusters, __version__)
        else:
            write_signature_clusters_bed(options.working_dir, signature_clusters)
            write_signature_clusters_vcf(options.working_dir, signature_clusters, __version__)

    logging.info("****************** STEP 3: COMBINE ******************")
    with timer.stage("combine"):
        (deletion_candidates, inversion_candidates, int_duplication_candidates,
         tan_dup_candidates, novel_insertion_candidates,
         breakend_candidates) = combine_clusters(signature_clusters, options)
        breakend_candidates_all_bnds = []
        if options.all_bnds:
            root_logger.setLevel(logging.WARNING)
            breakend_candidates_all_bnds = combine_clusters(
                translocation_clusters_all_bnds, options)[5]
            root_logger.setLevel(logging.DEBUG if options.verbose else logging.INFO)

    if not options.skip_genotyping:
        logging.info("****************** STEP 4: GENOTYPE ******************")
        from svim_tpu.genotype import genotype_packed_multi
        from svim_tpu.io.packed_fetch import PackedAlignmentIndex

        genotype_groups = (
            (deletion_candidates, "DEL", "deletions"),
            (inversion_candidates, "INV", "inversions"),
            (novel_insertion_candidates, "INS", "novel insertions"),
            (int_duplication_candidates, "DUP_INT", "interspersed duplications"),
        )
        with timer.stage("genotype"):
            if isinstance(aln_file, PackedAlignmentIndex) or hasattr(aln_file, "packed"):
                # vectorized interval join over the packed table (single-host
                # PackedAlignmentIndex or the distributed MergedAlignmentIndex):
                # all four types genotype in ONE device kernel invocation
                genotype_packed_multi(genotype_groups, aln_file.packed,
                                      aln_file.header, options)
            else:
                for candidates, type_name, label in genotype_groups:
                    logging.info("Genotyping {0}..".format(label))
                    genotype(candidates, aln_file, type_name, options)

    logging.info("Write SV candidates..")
    logging.info("Final deletion candidates: {0}".format(len(deletion_candidates)))
    logging.info("Final inversion candidates: {0}".format(len(inversion_candidates)))
    logging.info("Final interspersed duplication candidates: {0}".format(
        len(int_duplication_candidates)))
    logging.info("Final tandem duplication candidates: {0}".format(len(tan_dup_candidates)))
    logging.info("Final novel insertion candidates: {0}".format(
        len(novel_insertion_candidates)))
    logging.info("Final breakend candidates: {0}".format(len(breakend_candidates)))
    if options.all_bnds:
        logging.info("Final breakend candidates from other SV classes (DEL, INV, DUP): "
                     "{0}".format(len(breakend_candidates_all_bnds)))
    all_breakends = breakend_candidates + breakend_candidates_all_bnds

    with timer.stage("output"):
        if primary:
            write_candidates(options.working_dir,
                             (int_duplication_candidates, inversion_candidates,
                              tan_dup_candidates, deletion_candidates,
                              novel_insertion_candidates, all_breakends))
            write_final_vcf(int_duplication_candidates, inversion_candidates,
                            tan_dup_candidates, deletion_candidates,
                            novel_insertion_candidates, all_breakends, __version__,
                            aln_file.references, aln_file.lengths,
                            options.types_to_output, options)

    logging.info("Draw plots..")
    root_logger.setLevel(logging.WARNING)
    with timer.stage("plots"):
        if primary:
            write_plots(deletion_candidates, inversion_candidates,
                        int_duplication_candidates, tan_dup_candidates,
                        novel_insertion_candidates, options)
    root_logger.setLevel(logging.DEBUG if options.verbose else logging.INFO)
    timer.report()
    logging.info("Done.")
    return 0


def main(arguments=None):
    options = parse_arguments(program_version=__version__, arguments=arguments)
    if not options.sub:
        print("Please choose one of the two modes ('reads' or 'alignment'). "
              "See --help for more information.")
        return 1
    from svim_tpu.utils.device import pin_platform, resolve_platform
    pin_platform(options.device_backend)
    if options.distributed:
        # must run before the first jax computation creates backends
        from svim_tpu.parallel.multihost import initialize_from_env
        initialize_from_env()
    import jax
    resolve_platform(options.device_backend, jax.default_backend())
    _setup_logging(options)
    logging.info("****************** Start svim-tpu, version {0} ******************".format(
        __version__))
    logging.info("CMD: python3 {0}".format(" ".join(sys.argv)))
    logging.info("WORKING DIR: {0}".format(os.path.abspath(options.working_dir)))
    for field in sorted(vars(options)):
        logging.info("PARAMETER: {0}, VALUE: {1}".format(field, getattr(options, field)))
    try:
        return run_pipeline(options)
    except Exception as error:  # noqa: BLE001 - top-level CLI guard
        logging.error(error, exc_info=True)
        return 1


if __name__ == "__main__":
    sys.exit(main())
