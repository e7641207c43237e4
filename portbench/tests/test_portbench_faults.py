"""The correctness check fails what it must: the control (the reference
in bfloat16 in the program's place) and, for each fault a cell can have,
a run with the timed path broken underneath.  The cells run on one chip,
so there is no exchange between chips to leave out."""

from __future__ import annotations

import pytest
import torch

from conftest import run_cut


@pytest.mark.parametrize("cell", ["museum.session", "cloud100k.per_pixel", "museum.train"])
def test_control_is_not_correct(cut, cell):
    from portbench import harness
    _, out = run_cut(cut, cell, control=True)
    assert harness.verdict(out["checks"]), out["checks"]
    assert not harness.verdict(out["control_checks"]), out["control_checks"]


def _session_fault(monkeypatch, fault):
    from wasm_pathtracer_tpu_torch.ops import accum, adaptive, integrator

    if fault == "state_unchanged":
        # the frame's sums never reach the buffer
        monkeypatch.setattr(accum, "write_sums", lambda buf, s, c: buf)
        return
    if fault == "sweep_skewed":
        # past the bootstrap the sweep advances one pixel too far
        pick = adaptive.pick_pixels

        def skewed(buf, batch, seed, bootstrap, *args, **kw):
            px, py, density, pos = pick(buf, batch, seed, bootstrap, *args, **kw)
            return px, py, density, pos if bootstrap else pos + 1

        monkeypatch.setattr(adaptive, "pick_pixels", skewed)
        return
    queue = integrator.render_queue

    def broken(prep, scene, settings, camera, pix_queue, *args, **kw):
        if fault == "half_the_batch":
            # half of the queue left out, the rest weighted up to the mean
            acc, cnt, cost = queue(prep, scene, settings, camera,
                                   pix_queue[:pix_queue.shape[0] // 2], *args, **kw)
            return acc * 2.0, cnt * 2, cost
        acc, cnt, cost = queue(prep, scene, settings, camera, pix_queue, *args, **kw)
        # one answer altered where it is produced: the first sampled pixel's sum
        hit = torch.nonzero(cnt).squeeze(1)
        return acc.index_add(0, hit, torch.full((hit.shape[0], 3), 0.01)), cnt, cost

    monkeypatch.setattr(integrator, "render_queue", broken)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_batch", "answer_altered",
                                   "sweep_skewed"])
def test_session_fault_is_not_correct(cut, monkeypatch, fault):
    from portbench import harness
    from wasm_pathtracer_tpu_torch.runtime import session
    _session_fault(monkeypatch, fault)
    # the session module reaches render_queue through the integrator module
    assert session.integrator.render_queue is not None
    line, _ = run_cut(cut, "museum.session")
    assert line["correct"] is False, line["check"]
    assert not harness.verdict([dict(name=k, **v) for k, v in line["check"].items()])


@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_batch", "answer_altered"])
def test_train_fault_is_not_correct(cut, monkeypatch, fault):
    from wasm_pathtracer_tpu_torch.parallel import shard
    call, loss_of = shard.TrainStep.__call__, shard.TrainStep._loss

    if fault == "state_unchanged":
        def broken(self, scene, camera, target, seed):
            loss, _, _ = call(self, scene, camera, target, seed)
            return loss, scene, camera
        monkeypatch.setattr(shard.TrainStep, "__call__", broken)
    elif fault == "half_the_batch":
        def broken(self, prep, scene, camera, target, seed):
            # the second half of the pixels left out, the mean over the rest
            keep = torch.zeros_like(self._valid)
            keep[: keep.shape[0] // 2] = 2.0
            valid, self._valid = self._valid, self._valid * keep
            try:
                return loss_of(self, prep, scene, camera, target, seed)
            finally:
                self._valid = valid
        monkeypatch.setattr(shard.TrainStep, "_loss", broken)
    else:
        def broken(self, prep, scene, camera, target, seed):
            # the loss altered where it is produced: 5% high
            return 1.05 * loss_of(self, prep, scene, camera, target, seed)
        monkeypatch.setattr(shard.TrainStep, "_loss", broken)
    line, _ = run_cut(cut, "museum.train", seconds=0.5)
    assert line["correct"] is False, line["check"]
