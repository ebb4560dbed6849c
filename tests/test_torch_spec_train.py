"""``paddle_tpu_torch.tools.bench_serving --speculative
--spec-train-steps N`` on the CPU: the target pre-trained through the
port's ``TrainStep`` with ``Adam(3e-3)`` on the reference's synthetic
stream before the speculative legs (reference ``_train_synthetic``). The
line reports the steps, and the loss falls; the training batches are the
reference's draws from ``np.random.RandomState(--seed)``."""
import json

import numpy as np
import torch

from paddle_tpu_torch.tools import bench_serving

torch.set_num_threads(2)


def _reference_batches(seed, steps, vocab, maxpos):
    """The reference's draw order (tools/bench_serving.py:747-755)."""
    trng = np.random.RandomState(seed)
    s = min(24, maxpos - 1)
    out = []
    for _ in range(steps):
        x = np.zeros((16, s + 1), np.int64)
        x[:, 0] = trng.randint(0, vocab, 16)
        for t in range(1, s + 1):
            nxt = (x[:, t - 1] + 7) % vocab
            ns = trng.rand(16) < 0.08
            x[:, t] = np.where(ns, trng.randint(0, vocab, 16), nxt)
        out.append(x)
    return out


def test_speculative_line_reports_the_training(capsys, monkeypatch):
    from paddle_tpu_torch.parallel import api
    seen = []
    call = api.TrainStep.__call__

    def spy(self, *batch):
        seen.append(np.asarray(batch[0]))
        return call(self, *batch)
    monkeypatch.setattr(api.TrainStep, "__call__", spy)
    bench_serving.main(["--model", "tiny", "--device", "cpu",
                        "--speculative", "--spec-train-steps", "20",
                        "--requests", "4", "--slots", "4"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert len(lines) == 1
    rec = lines[0]
    assert rec["spec_train_steps"] == 20
    assert rec["spec_train_loss_last"] < rec["spec_train_loss_first"] - 0.5
    assert rec["accept_rate"] is not None
    want = _reference_batches(0, 20, 128, 128)
    assert len(seen) == 20
    for got, x in zip(seen, want):
        np.testing.assert_array_equal(got, x[:, :-1])


def test_zero_steps_serve_the_random_target(capsys):
    bench_serving.main(["--model", "tiny", "--device", "cpu",
                        "--speculative", "--spec-train-steps", "0",
                        "--requests", "2", "--slots", "2"])
    rec = json.loads([x for x in capsys.readouterr().out.splitlines()
                      if x.startswith("{")][-1])
    assert rec["spec_train_steps"] == 0
    assert rec["spec_train_loss_first"] is None
