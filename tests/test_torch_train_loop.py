"""The port's trainer end to end on the CPU at smoke size, as the JAX
``tests/test_system.py`` runs the reference's (unmarked here, so tier 1 runs
it), and the pieces it wires together: the data pipeline, the checkpoint
manager and the supervisor.  Every thread a test starts is closed in a
``finally``."""
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JaxCheckpointManager
from repro.data import pipeline as jpipe
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data import pipeline as tpipe
from repro_torch.launch.train import main
from repro_torch.runtime.supervisor import Supervisor

SMOKE = ["--arch", "qwen1.5-0.5b", "--smoke", "--device", "cpu",
         "--log-every", "100"]


def test_train_loop_learns(tmp_path):
    losses = main(SMOKE + ["--steps", "40", "--batch", "4", "--seq", "64",
                           "--ckpt-every", "1000", "--ckpt-dir",
                           str(tmp_path)])
    assert len(losses) == 40
    assert np.isfinite(losses).all()
    # synthetic bigram structure is learnable: loss must drop
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.05


def test_train_resume_is_exact(tmp_path):
    args = SMOKE + ["--batch", "2", "--seq", "32", "--ckpt-every", "10"]
    full = main(args + ["--steps", "20", "--ckpt-dir", str(tmp_path / "a")])
    d2 = str(tmp_path / "b")
    first = main(args + ["--steps", "10", "--ckpt-dir", d2])
    resumed = main(args + ["--steps", "20", "--ckpt-dir", d2, "--resume"])
    assert len(first) == len(resumed) == 10
    # deterministic data pipeline + exact state restore => identical tail
    np.testing.assert_allclose(first, full[:10], rtol=1e-6)
    np.testing.assert_allclose(resumed, full[10:], rtol=1e-4)


def test_grad_compression_still_learns(tmp_path):
    losses = main(SMOKE + ["--steps", "30", "--batch", "4", "--seq", "64",
                           "--ckpt-every", "1000", "--ckpt-dir",
                           str(tmp_path), "--grad-compression", "int8_ef"])
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.03


def test_trainer_needs_a_card_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--arch", "qwen1.5-0.5b", "--smoke", "--steps", "1",
              "--ckpt-dir", str(tmp_path)])


# ---------------------------------------------------------------------------
# The pieces
# ---------------------------------------------------------------------------


def test_pipeline_is_the_reference_and_prefetch_stops_on_close():
    cfg = dict(vocab_size=97, seq_len=16, global_batch=4, seed=3)
    tp = tpipe.SyntheticTokenPipeline(tpipe.DataConfig(**cfg))
    jp = jpipe.SyntheticTokenPipeline(jpipe.DataConfig(**cfg))
    for step in (0, 1, 7):
        np.testing.assert_array_equal(tp.batch_at(step)["tokens"],
                                      jp.batch_at(step)["tokens"])
    it = tpipe.PrefetchIterator(tp, start_step=5, depth=2)
    try:
        got = [next(it) for _ in range(3)]
    finally:
        it.close()
    assert not it._thread.is_alive() and it._thread.daemon
    assert [s for s, _ in got] == [5, 6, 7]
    np.testing.assert_array_equal(got[2][1]["tokens"],
                                  jp.batch_at(7)["tokens"])


def _state():
    g = torch.Generator().manual_seed(0)
    return {"params": {"w": torch.randn(3, 4, generator=g),
                       "h": {"b": torch.randn(5, generator=g).bfloat16()}},
            "opt_state": {"step": torch.tensor(7, dtype=torch.int32)}}


def test_checkpoint_round_trip_and_atomic_latest(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), keep=2)
    try:
        assert ckpt.latest_step() is None
        state = _state()
        for step in (1, 2, 3):
            ckpt.save(step, state, extra={"note": step})
            state["params"]["w"].add_(1.0)     # after save: not in the file
        ckpt.wait()
    finally:
        ckpt.wait()
    assert ckpt.latest_step() == 3
    assert sorted(p.name for p in tmp_path.iterdir()
                  if p.name.startswith("step_")) == ["step_000000002",
                                                     "step_000000003"]
    step, tree = ckpt.restore()
    want = _state()
    want["params"]["w"].add_(2.0)
    assert step == 3
    assert torch.equal(tree["params"]["w"], want["params"]["w"])
    assert tree["params"]["h"]["b"].dtype == torch.bfloat16
    assert torch.equal(tree["params"]["h"]["b"], want["params"]["h"]["b"])
    assert tree["opt_state"]["step"].dtype == torch.int32
    assert int(tree["opt_state"]["step"]) == 7
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore()


def test_checkpoint_layout_is_the_reference_s(tmp_path):
    """A checkpoint the port writes, the JAX manager reads, and back."""
    state = {"params": {"w": torch.arange(6.0).reshape(2, 3)},
             "opt_state": {"step": torch.tensor(4, dtype=torch.int32)}}
    ours = CheckpointManager(str(tmp_path / "port"), async_write=False)
    ours.save(4, state)
    step, tree = JaxCheckpointManager(str(tmp_path / "port")).restore()
    assert step == 4
    np.testing.assert_array_equal(np.asarray(tree["params"]["w"]),
                                  state["params"]["w"].numpy())
    theirs = JaxCheckpointManager(str(tmp_path / "jax"), async_write=False)
    theirs.save(9, {"params": {"w": np.ones((2, 2), np.float32)}})
    step, tree = CheckpointManager(str(tmp_path / "jax")).restore()
    assert step == 9 and torch.equal(tree["params"]["w"], torch.ones(2, 2))


def test_checkpoint_write_error_surfaces_on_wait(tmp_path):
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    (tmp_path / "not_a_dir").write_text("")
    ckpt.directory = str(tmp_path / "not_a_dir")
    try:
        ckpt.save(1, {"x": torch.zeros(2)})
        with pytest.raises(NotADirectoryError):
            ckpt.wait()
    finally:
        ckpt.wait()                       # the error was raised once only
    assert ckpt.latest_step() is None


def test_supervisor_heartbeat():
    clock = [0.0]
    sup = Supervisor(num_workers=1, clock=lambda: clock[0])
    sup.heartbeat(0, 3, 0.5)
    sup.heartbeat(0, 4, 1.0)
    w = sup.workers[0]
    assert w.step == 4 and w.step_time_ema == pytest.approx(0.65)
    clock[0] = 10.0
    assert sup.check()["failed"] == [0] and sup.alive_count() == 0
