"""repro_torch's token pipeline (``data/pipeline.py``) and LM training driver
(``launch/train.py``) on the CPU.

The pipeline's batches equal the JAX package's bit for bit (the same numpy
code): ``SyntheticLM`` and ``DocPackLM`` across steps and host splits. The
driver, on ``--device cpu`` (the kernels' plain versions), trains a SMOKE
model with a falling loss; its ``--chaos-step`` drill restarts once from the
latest checkpoint and ends bit for bit where an uninterrupted run ends (every
step's loss, and the last checkpoint's every leaf); ``--recover`` prints the
JAX launcher's lines; the ``vlm`` and ``audio`` families and more than one
device are refused.
"""

from __future__ import annotations

import re
import tempfile

import numpy as np
import pytest
import torch

from repro.data import pipeline as jpipe
from repro_torch.checkpoint.checkpoint import restore_checkpoint
from repro_torch.configs import get_config
from repro_torch.data import pipeline
from repro_torch.launch import train
from repro_torch.parallel import init_train_state
from repro_torch.tree import tree_leaves


@pytest.mark.parametrize("source", ["SyntheticLM", "DocPackLM"])
def test_batches_equal_jax_bit_for_bit(source):
    cfg = pipeline.PipelineConfig(vocab_size=512, seq_len=48, global_batch=4, seed=3)
    jcfg = jpipe.PipelineConfig(vocab_size=512, seq_len=48, global_batch=4, seed=3)
    ours, theirs = getattr(pipeline, source)(cfg), getattr(jpipe, source)(jcfg)
    for step in (0, 1, 7):
        for host_id, n_hosts in ((0, 1), (1, 2), (3, 4)):
            got, want = ours.batch_at(step, host_id, n_hosts), theirs.batch_at(step, host_id, n_hosts)
            assert sorted(got) == sorted(want) == ["labels", "tokens"]
            for k in got:
                assert got[k].dtype == want[k].dtype == np.int32
                assert got[k].shape == (4 // n_hosts, 48)
                np.testing.assert_array_equal(got[k], want[k])
    assert not np.array_equal(ours.batch_at(0)["tokens"], ours.batch_at(1)["tokens"])


def test_the_batch_reaches_the_device_as_int64():
    batch = pipeline.SyntheticLM(pipeline.PipelineConfig(512, 16, 2)).batch_at(0)
    dev = pipeline.to_device_batch(dict(batch, frames=np.ones((2, 3), np.float32)), "cpu")
    assert dev["tokens"].dtype == dev["labels"].dtype == torch.int64
    assert dev["frames"].dtype == torch.float32
    np.testing.assert_array_equal(dev["tokens"].numpy(), batch["tokens"])
    with pytest.raises(ValueError, match="does not split over 3 hosts"):
        pipeline.SyntheticLM(pipeline.PipelineConfig(512, 16, 2)).batch_at(0, 0, 3)


def _args(*extra, tmp_path=None):
    argv = ["--arch", "mamba2-130m", "--batch", "2", "--seq", "32", "--device", "cpu", *extra]
    if tmp_path is not None:
        argv += ["--ckpt-dir", str(tmp_path)]
    return train.build_parser().parse_args(argv)


def test_the_loss_falls(capsys, tmp_path):
    """20 steps of mamba2-130m SMOKE at B = 4, S = 64 (the README's command):
    the mean loss of the last 5 steps below the first 5's; the JAX launcher's
    summary and step lines."""
    argv = ["--arch", "mamba2-130m", "--steps", "20", "--batch", "4", "--seq", "64",
            "--device", "cpu", "--save-every", "0", "--log-every", "5",
            "--ckpt-dir", str(tmp_path)]  # fmt: skip
    result = train.run(train.build_parser().parse_args(argv))
    losses = [h["loss"] for h in result["history"]]
    assert len(losses) == 20 and all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    assert result["restarts"] == 0 and result["final_mesh"] == (1, 1)
    assert train.main(argv) == 0
    out = capsys.readouterr().out
    assert re.search(r"\[train\] arch=mamba2-130m steps=20 restarts=0 mesh=\(1, 1\) loss "
                     r"[\d.]+ -> [\d.]+ \(\d+s\)", out)  # fmt: skip
    assert len(re.findall(r"  step +\d+ mesh=\(1, 1\) loss=[\d.]+ \d+ms", out)) == 4


def test_the_chaos_drill_ends_where_an_uninterrupted_run_ends(tmp_path):
    """A failure before step 5 (``--save-every 2``): one restart from the
    checkpoint of step 4; every step's loss, and the checkpoint of step 6,
    bit for bit those of a run without the failure."""
    drill = train.run(_args("--steps", "8", "--save-every", "2", "--chaos-step", "5",
                            tmp_path=tmp_path / "drill"))  # fmt: skip
    plain = train.run(_args("--steps", "8", "--save-every", "2", tmp_path=tmp_path / "plain"))
    assert drill["restarts"] == 1 and plain["restarts"] == 0
    assert [h["step"] for h in drill["history"]] == list(range(8))
    assert [h["loss"] for h in drill["history"]] == [h["loss"] for h in plain["history"]]
    like = init_train_state(torch.Generator().manual_seed(1), get_config("mamba2-130m", smoke=True),
                            "cpu")  # fmt: skip
    a, _ = restore_checkpoint(tmp_path / "drill", 6, like)
    b, _ = restore_checkpoint(tmp_path / "plain", 6, like)
    assert int(a.step) == 7
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)


def test_a_run_resumes_from_its_checkpoint(tmp_path):
    """A second run in the same ``--ckpt-dir`` resumes after the last
    checkpoint (step 4) and takes only the steps left."""
    train.run(_args("--steps", "5", "--save-every", "2", tmp_path=tmp_path))
    again = train.run(_args("--steps", "7", "--save-every", "2", tmp_path=tmp_path))
    assert [h["step"] for h in again["history"]] == [5, 6]


def test_without_a_ckpt_dir_no_run_resumes_another(tmp_path, monkeypatch):
    """With no ``--ckpt-dir`` a run checkpoints into a temporary directory of
    its own, removed when it ends: a second run takes every step again, and
    the temporary directory is left empty."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    for _ in range(2):
        result = train.run(_args("--steps", "3", "--save-every", "1"))
        assert [h["step"] for h in result["history"]] == [0, 1, 2]
    assert not any(tmp_path.iterdir())


def test_recover_prints_the_jax_lines(capsys):
    assert train.main(["--recover", "lorenz", "--steps", "20", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert re.search(r"\[recover\] 1 systems x 20 steps in [\d.]+s \(one stacked program; "
                     r"library order 2, 10 terms\)", out)  # fmt: skip
    assert re.search(r"  lorenz +\|theta\|_max=[\d.]+ active_terms~\d+", out)


@pytest.mark.parametrize("argv,match", [
    (["--arch", "phi-3-vision-4.2b"], r"needs batch\['patches'\]"),
    (["--arch", "seamless-m4t-medium"], r"needs batch\['frames'\]"),
    (["--data", "2"], "the port trains on one device"),
    (["--model", "2"], "the port trains on one device"),
])  # fmt: skip
def test_what_the_driver_cannot_train_is_refused(argv, match, tmp_path):
    args = train.build_parser().parse_args([*argv, "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    with pytest.raises(ValueError, match=match):
        train.run(args)
    assert not any(tmp_path.iterdir())


def test_the_card_is_the_default_and_is_not_replaced(monkeypatch, tmp_path):
    """``--device`` defaults to cuda; without a card the driver raises rather
    than train on the CPU."""
    assert train.build_parser().parse_args([]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.run(train.build_parser().parse_args(["--arch", "mamba2-130m", "--ckpt-dir",
                                                   str(tmp_path)]))  # fmt: skip
