"""Dry-run parity for the recurrent families (rwkv6's WKV, jamba's Mamba
hybrid with GQA and MoE): the port's count of a step equals the reference
walker's, every op but the scans held exactly (``_torch_dryrun_parity``
stands elementwise functions in for the scans in both packages); on
``meta`` the scan kernels add their formulas, as
``test_torch_cost.py`` holds them to closed forms.
"""
import pytest

from _torch_dryrun_parity import SCAN_KERNELS, check_cell


@pytest.mark.parametrize("arch,mode", [
    (arch, mode) for arch in ("rwkv6-1.6b", "jamba-1.5-large-398b")
    for mode in ("train", "prefill", "decode")])
def test_count_equals_the_walker_but_the_scans(monkeypatch, arch, mode):
    _, _, meta = check_cell(monkeypatch, arch, mode)
    scans = {k for k in SCAN_KERNELS if meta["by_op"].get(k)}
    want = {("rwkv6-1.6b", "train"): {"rwkv6_scan", "rwkv6_scan_bwd"},
            ("rwkv6-1.6b", "prefill"): {"rwkv6_scan"},
            ("rwkv6-1.6b", "decode"): set(),         # computed inline
            ("jamba-1.5-large-398b", "train"): {"ssm_scan", "ssm_scan_bwd"},
            ("jamba-1.5-large-398b", "prefill"): {"ssm_scan"},
            ("jamba-1.5-large-398b", "decode"): {"ssm_scan"}}[arch, mode]
    assert scans == want
