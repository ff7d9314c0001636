"""chip_smoke.py's comparison helpers at a tiny size on the CPU.

The same helpers check the kernels compiled for the card in chip_smoke.py
and in tests/test_gpu_kernels.py."""

import os

import pytest

import chip_smoke


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    """A 1024-read bench workload (split reads included), its first 512
    records and parsed options."""
    import bench
    from svim_tpu.config import parse_arguments

    root = str(tmp_path_factory.mktemp("smoke"))
    bam, genome = bench.make_workload(root, 1024)
    header, records = chip_smoke.head_records(bam, 512)
    options = parse_arguments(arguments=["alignment", root, bam, genome])
    return bam, genome, header, records, options


def test_head_records_match_full_parse(workload):
    from svim_tpu.io.bam import read_bam

    bam, _genome, header, records, _options = workload
    full_header, full = read_bam(bam)
    assert header.references == full_header.references
    assert len(records) == 512
    for got, want in zip(records, full[:512]):
        assert (got.query_name, got.reference_start, got.cigartuples,
                got.query_sequence, got.tags) == (
            want.query_name, want.reference_start, want.cigartuples,
            want.query_sequence, want.tags)


def test_cigar_scan_matches_host(workload):
    *_rest, records, options = workload
    results, width = chip_smoke.check_cigar_scan(records, options.min_sv_size)
    assert width >= 3001
    assert {name: bad for name, (bad, _f, _w) in results.items()} == {
        "collect_scan[raw]": 0, "collect_scan[compacted]": 0,
        "collect_scan_u8[raw]": 0}


def test_cigar_scan_counts_a_wrong_row(workload, monkeypatch):
    """A kernel that misplaces one event is caught (mutation check)."""
    from svim_tpu.ops import cigar_kernel

    *_rest, records, options = workload
    original = cigar_kernel.collect_scan

    def shifted(*args, **kwargs):
        out = list(original(*args, **kwargs))
        out[6] = out[6].at[0].add(1)  # pos_ref of the first event
        return tuple(out)

    monkeypatch.setattr(cigar_kernel, "collect_scan", shifted)
    results, _width = chip_smoke.check_cigar_scan(records[:64],
                                                  options.min_sv_size)
    assert results["collect_scan[raw]"][0] == 1
    assert results["collect_scan_u8[raw]"][0] == 0


def test_split_read_signatures_match_host(workload):
    from svim_tpu.collect import analyze_alignment_file_coordsorted
    from svim_tpu.collect.packed import collect_signatures_packed
    from svim_tpu.io.sam import AlignmentFile

    _bam, _genome, header, records, options = workload
    sliced = AlignmentFile("slice", records=records, header=header)
    with chip_smoke.KernelSpy("svim_tpu.ops.segments_kernel",
                              "classify_groups_fused") as spy:
        device, device_trans = collect_signatures_packed(sliced, options)
    host, host_trans = analyze_alignment_file_coordsorted(sliced, options)
    assert spy.calls >= 1 and spy.first_s is not None
    assert spy.warm_median(repeats=2) > 0
    assert chip_smoke.signature_mismatches(device, host) == 0
    assert chip_smoke.signature_mismatches(device_trans, host_trans) == 0
    assert chip_smoke.signature_mismatches(device[1:], host) == 1
    # the spy is removed on exit
    from svim_tpu.ops import segments_kernel
    assert segments_kernel.classify_groups_fused is spy.original


def test_linkage_check_on_partitions(workload):
    from svim_tpu.cluster.partition import form_partitions
    from svim_tpu.signatures import SignatureDeletion

    *_rest, options = workload
    # tie-free partitions: distinct spans, one read each
    samples = []
    for part in range(3):
        sample = [SignatureDeletion("chr1", 10000 * part + 37 * i * i,
                                    10000 * part + 37 * i * i + 300 + 7 * i,
                                    "cigar", "p{0}r{1}".format(part, i))
                  for i in range(6 + part)]
        samples.extend(form_partitions(sample, options.partition_max_distance))
    result = chip_smoke.check_linkage(samples, options)
    assert result["partitions"] == len(samples)
    assert result["distance_mismatches"] == 0
    assert result["merge_mismatches"] == 0
    assert result["merge_rows_compared"] + result["guard_flagged"] == len(
        samples)
    assert result["merge_rows_compared"] >= 1


def test_wavefront_check_matches_native():
    from svim_tpu.native import get_library

    if get_library() is None:
        pytest.skip("native library unavailable")
    pairs = [("ACGT" * 30, "ACGA" * 30), ("A" * 90, "A" * 80 + "C" * 15),
             ("ACGTACGT" * 10, "ACGTACGA" * 10)] * 4
    hints = [len(a) + len(b) for a, b in pairs]
    bad, device_s, native_s = chip_smoke.check_wavefront(pairs, hints,
                                                         repeats=1)
    assert bad == 0 and device_s > 0 and native_s > 0


def test_cli_run_genotype_check_and_stage_times(workload, tmp_path):
    bam, genome, *_rest = workload
    workdir = str(tmp_path / "wd")
    jobs = chip_smoke.KernelSpy("svim_tpu.ops.genotype_kernel",
                                "genotype_ref_support_device")
    with jobs:
        code, _seconds = chip_smoke.run_cli(["alignment", workdir, bam,
                                             genome, "--profile"])
    assert code == 0
    served, bad = chip_smoke.check_genotype(jobs)
    assert served > 0 and bad == 0
    times = chip_smoke.stage_times(workdir)
    assert {"collect", "cluster", "combine", "genotype", "output"} <= set(times)
    assert chip_smoke.telemetry_from_log(workdir) is not None


def test_vcf_body_ignores_only_the_file_date(tmp_path):
    first = tmp_path / "a.vcf"
    second = tmp_path / "b.vcf"
    first.write_text("##fileformat=VCFv4.2\n##fileDate=1\nchr1\t5\n")
    second.write_text("##fileformat=VCFv4.2\n##fileDate=2\nchr1\t5\n")
    assert chip_smoke.vcf_body(str(first)) == chip_smoke.vcf_body(str(second))
    second.write_text("##fileformat=VCFv4.2\n##fileDate=2\nchr1\t6\n")
    assert chip_smoke.vcf_body(str(first)) != chip_smoke.vcf_body(str(second))


def test_smoke_refuses_without_gpu(capsys):
    """Without a GPU the script exits non-zero, names the platform it found
    and prints no result line."""
    assert chip_smoke.main([]) == 2
    captured = capsys.readouterr()
    assert "no GPU" in captured.err and "'cpu'" in captured.err
    assert '"ok"' not in captured.out
    assert os.path.exists(os.path.join(chip_smoke.REPO, "bench.py"))
