"""The port stands alone: no JAX, nothing of ``repro``, and no quiet CPU
fallback at its entry points."""
import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py", ROOT / "compare_kernels.py"]


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_files_exist():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for twin in ("models/layers.py", "models/attention.py", "models/blocks.py",
                 "models/lm.py", "models/api.py", "launch/steps.py",
                 "launch/serve.py", "core/config.py", "configs/qwen1_5_0_5b.py",
                 "configs/minitron_8b.py", "kernels/decode_attention/ops.py",
                 "kernels/flash_attention/ops.py", "models/rwkv6.py",
                 "configs/rwkv6_1_6b.py", "kernels/rwkv6_scan/ops.py",
                 "models/ssm.py", "configs/jamba_1_5_large_398b.py",
                 "configs/granite_moe_1b_a400m.py", "kernels/ssm_scan/ops.py",
                 "optim/adamw.py", "launch/train.py", "data/pipeline.py",
                 "runtime/supervisor.py", "checkpoint/manager.py",
                 "models/dilated_vgg.py", "configs/dilated_vgg.py",
                 "models/encdec.py", "configs/internvl2_2b.py",
                 "configs/seamless_m4t_large_v2.py", "core/hw.py",
                 "core/estimator/roofline.py", "core/cost/analysis.py",
                 "launch/dryrun.py", "launch/perf.py"):
        assert f"src/repro_torch/{twin}" in names
    assert "chip_smoke.py" in names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_and_nothing_of_repro(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), \
            f"{path.relative_to(ROOT)} imports {mod}"


def test_default_device_raises_without_cuda(monkeypatch):
    from repro_torch.core.device import resolve_device
    from repro_torch.launch import serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.BatchedServer(cfg=None, batch_slots=1, max_len=4,
                            decode_fn=lambda *a: None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "qwen1.5-0.5b", "--smoke"])
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
