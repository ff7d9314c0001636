"""--device_backend decision, compile-cache location, optional matplotlib."""

import os
import sys

import pytest

from svim_tpu.utils.device import (
    CACHE_ENV,
    DEFAULT_CACHE_DIR,
    compilation_cache_dir,
    resolve_platform,
)


@pytest.mark.parametrize("backend,default,want", [
    ("auto", "gpu", "gpu"),
    ("auto", "cpu", "cpu"),
    ("gpu", "gpu", "gpu"),
    ("cpu", "gpu", "cpu"),
    ("cpu", "cpu", "cpu"),
    ("host", "gpu", "cpu"),
    ("host", "cpu", "cpu"),
])
def test_resolve_platform(backend, default, want):
    assert resolve_platform(backend, default) == want


@pytest.mark.parametrize("backend", ["gpu", "bogus"])
def test_resolve_platform_refuses(backend):
    """'gpu' without a GPU raises instead of falling back to the CPU; an
    unknown choice raises too."""
    with pytest.raises((RuntimeError, ValueError)):
        resolve_platform(backend, "cpu")


def test_cli_gpu_backend_raises_without_gpu(tmp_path):
    from svim_tpu.cli import main

    with pytest.raises(RuntimeError, match="no GPU"):
        main(["alignment", str(tmp_path / "wd"), str(tmp_path / "x.bam"),
              str(tmp_path / "g.fa"), "--device_backend", "gpu"])


def test_cache_dir_honours_env():
    assert compilation_cache_dir({CACHE_ENV: "/cache/here"}) == "/cache/here"


def test_cache_dir_default_is_fixed_in_checkout():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert compilation_cache_dir({}) == DEFAULT_CACHE_DIR
    assert DEFAULT_CACHE_DIR == os.path.join(repo, ".jax_cache")
    with open(os.path.join(repo, ".gitignore")) as handle:
        assert ".jax_cache/" in handle.read().split()


def _tiny_dataset(tmp_path):
    import random

    rng = random.Random(7)
    genome = "".join(rng.choice("ACGT") for _ in range(30000))
    genome_path = tmp_path / "genome.fa"
    genome_path.write_text(">chr1\n" + "\n".join(
        genome[i:i + 60] for i in range(0, len(genome), 60)) + "\n")
    lines = ["@HD\tVN:1.6\tSO:coordinate", "@SQ\tSN:chr1\tLN:30000"]
    for i in range(8):
        start = 9000 - i * 41
        left = genome[start:10000]
        right = genome[10400:11800]
        lines.append("del{0}\t0\tchr1\t{1}\t60\t{2}M400D{3}M\t*\t0\t0\t{4}\t*"
                     .format(i, start + 1, len(left), len(right), left + right))
    sam_path = tmp_path / "reads.sam"
    sam_path.write_text("\n".join(lines) + "\n")
    return str(sam_path), str(genome_path)


def test_cli_runs_without_matplotlib(tmp_path, monkeypatch, caplog):
    """Without matplotlib the VCF, BEDs and logs are still written and one
    warning names the skipped plots."""
    from svim_tpu.cli import main

    sam, genome = _tiny_dataset(tmp_path)
    for name in [m for m in sys.modules if m.split(".")[0] == "matplotlib"]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import fails
    workdir = tmp_path / "wd"
    assert main(["alignment", str(workdir), sam, genome]) == 0
    vcf = (workdir / "variants.vcf").read_text()
    assert "SVTYPE=DEL" in vcf
    assert not list(workdir.glob("*.png"))
    warnings = [r.getMessage() for r in caplog.records
                if "matplotlib is not installed" in r.getMessage()]
    assert len(warnings) == 1
    assert "sv-lengths-q5.png" in warnings[0]
    assert "sv-genotypes-q5.png" in warnings[0]
