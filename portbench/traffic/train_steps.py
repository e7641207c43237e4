"""Traffic kind ``train_steps``: inverse rendering as a user runs it.

Set-up builds the scene of the configuration and the port's train step,
``parallel.make_train_step`` on the one-member ray mesh, with plain SGD;
renders the target with the true scene (``render_image_sharded``,
``target_spp`` samples a pixel); shifts the diffuse albedos by
``albedo_shift`` (clamped to [0, 1]); and drives the step through its
first ``checked_steps`` steps, which the reference follows.  The window
then hands that same step object and state more steps until
``--seconds`` have passed.  Step ``k``'s seed is drawn from the run's
seed and ``k``.

Parameters (``traffic/<name>.json``): ``render_type``, ``max_bounces``,
``lr``, ``spp``, ``train_materials`` and ``train_camera`` (the descent
leaves: albedo and emission, the camera's location and rotations),
``target_spp``, ``albedo_shift``, ``checked_steps``,
``profile_steps`` (steps in a traced run's profiled slice, after the
window) and ``reference_block_pixels`` (the reference renders in blocks
of that many pixels).
"""

from __future__ import annotations

import sys
import time

from portbench import harness

KERNELS = {"fused_nearest": "fused_nearest_kernel", "fused_occluded": "fused_occluded_kernel"}


def leaves_of(scene, camera) -> dict:
    return {"albedo": scene.albedo.detach().clone(),
            "emission": scene.emission.detach().clone(),
            "location": camera.location.detach().clone(),
            "rot_x": camera.rot_x.detach().clone(), "rot_y": camera.rot_y.detach().clone()}


def build(run):
    """(step, scene, camera, target): the program's train step, the
    perturbed start and the target."""
    import torch
    from wasm_pathtracer_tpu_torch.config import RenderSettings, RenderType
    from wasm_pathtracer_tpu_torch.models import scenes
    from wasm_pathtracer_tpu_torch.models.camera import initial_camera
    from wasm_pathtracer_tpu_torch.models.scene import MatKind
    from wasm_pathtracer_tpu_torch.ops import trace
    from wasm_pathtracer_tpu_torch.parallel import (make_ray_mesh, make_train_step,
                                                    render_image_sharded)
    cfg, tf, dev = run.config, run.traffic, run.device
    W, H = cfg["width"], cfg["height"]
    scene = scenes.select_scene(cfg["scene_id"], device=dev)
    prep = trace.prepare(scene)
    st = dict(cfg["settings"], render_type=RenderType(tf["render_type"]),
              max_bounces=tf["max_bounces"])
    st = RenderSettings(**st)
    mesh = make_ray_mesh(device=dev)
    cam = initial_camera(cfg["scene_id"], dev)
    with torch.no_grad():
        target = render_image_sharded(mesh, prep, scene, st, cam, W, H,
                                      harness.fold(run.seed, 0x7A46), spp=tf["target_spp"])
    diffuse = (scene.mat_kind == int(MatKind.DIFFUSE))[:, None]
    shift = torch.tensor([tf["albedo_shift"]], dtype=torch.float32, device=mesh.device)
    start = scene.with_materials(
        albedo=torch.clamp(scene.albedo + torch.where(diffuse, shift, 0.0), 0, 1))
    step = make_train_step(mesh, prep, st, W, H, lr=tf["lr"], spp=tf["spp"],
                           train_materials=tf["train_materials"],
                           train_camera=tf["train_camera"])
    return step, start, cam, target


def run(run, control: bool = False) -> dict:
    """One run of the cell.  With ``control`` it also judges the control,
    the reference in bfloat16 put in the program's place
    (``out["control_checks"]``)."""
    import torch
    from wasm_pathtracer_tpu_torch.ops import scene_kernels as sk
    cfg, tf, dev = run.config, run.traffic, run.device
    rays = cfg["width"] * cfg["height"] * tf["spp"]
    wrappers = {k: getattr(sk, k) for k in KERNELS}
    step, cur, cam, target = build(run)
    states, losses = [leaves_of(cur, cam)], []
    for k in range(tf["checked_steps"]):
        loss, cur, cam = step(cur, cam, target, harness.fold(run.seed, k))
        losses.append(loss.detach().clone())
        states.append(leaves_of(cur, cam))
    if dev != "cpu":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - run.t0

    k = tf["checked_steps"]
    window_losses = []
    t_start = time.perf_counter()
    while time.perf_counter() - t_start < run.seconds:
        with run.span("train_step"):
            loss, cur, cam = step(cur, cam, target, harness.fold(run.seed, k))
        window_losses.append(loss.detach())
        k += 1
    if dev != "cpu":
        torch.cuda.synchronize(dev)
    window_s = time.perf_counter() - t_start
    n = len(window_losses)
    failed = int((~torch.isfinite(torch.stack(window_losses))).sum()) if n else 0
    device = {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    if dev != "cpu":
        device = harness.card()
        device["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated())
    e2e = {"setup_s": {"value": setup_s, "unit": "s"},
           "grad_rays_per_s": {"value": rays * n / window_s, "unit": "rays/s"}}
    out = {"end_to_end": {m["name"]: e2e[m["name"]] for m in run.end_to_end if m["name"] in e2e},
           "attempted": n, "failed": failed, "device": device}
    if run.trace:
        host = {"window_s": window_s}
        if dev != "cpu":
            torch.cuda.reset_peak_memory_stats(dev)
            loss, cur, cam = step(cur, cam, target, harness.fold(run.seed, k))
            torch.cuda.synchronize(dev)
            host["step_peak_bytes"] = int(torch.cuda.max_memory_allocated(dev))
            k += 1

        def steps():
            nonlocal cur, cam, k
            for _ in range(tf["profile_steps"]):
                with run.span("train_step"):
                    _, cur, cam = step(cur, cam, target, harness.fold(run.seed, k))
                k += 1

        obs = harness.Observed(config=cfg, counters={"steps": n}, host=host, profile=None)
        obs.profile = harness.profile_slice(steps, wrappers, KERNELS, [], tf["profile_steps"])
        out["per_layer"] = harness.read_per_layer(run, obs)
        out["breakdown"] = harness.breakdown(obs.profile)
        out["device"]["busy_s"] = obs.profile.busy_s()
        out["device"]["window_s"] = obs.profile.wall_s
    del step, cur, cam
    if dev != "cpu":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    out["checks"] = judge(run, [float(x) for x in losses], states)
    out["reference_s"] = time.perf_counter() - t_ref
    if control:
        from portbench.reference import train_check as tc
        for key, precision, fault in (("control_checks", "bfloat16", None),
                                      ("fault_half_the_batch", "float32", "half_the_batch"),
                                      ("fault_answer_altered", "float32", "answer_altered")):
            ctrl = tc.TrainReference(cfg, tf, dev, precision, fault)
            c_target = ctrl.target(harness.fold(run.seed, 0x7A46), tf["target_spp"])
            c_states, c_losses = [ctrl.start()], []
            for k in range(tf["checked_steps"]):
                loss, new = ctrl.step(c_states[-1], c_target, harness.fold(run.seed, k))
                c_losses.append(loss)
                c_states.append(new)
            out[key] = judge(run, c_losses, c_states)
    return out


def judge(run, losses: list, states: list, precision: str = "float32") -> list:
    """The numbers that decide ``correct``: each checked step's loss, the
    first step's gradient (its update over the learning rate) and the
    change after the checked steps, by the worst leaf, against the
    reference's."""
    from portbench.reference import train_check as tc
    tf, lim = run.traffic, run.checks["limits"]
    ref = tc.TrainReference(run.config, tf, run.device, precision)
    target = ref.target(harness.fold(run.seed, 0x7A46), tf["target_spp"])
    r_states = [ref.start()]
    r_losses = []
    for k in range(len(losses)):
        loss, new = ref.step(r_states[-1], target, harness.fold(run.seed, k))
        r_losses.append(loss)
        r_states.append(new)
    missing = int(len(losses) < tf["checked_steps"] or not states)
    checks = [{"name": "missing_answers", "value": missing, "limit": 0}]
    if missing:
        return checks

    def update(s):
        return {key: (s[0][key].to(ref.device) - s[1][key].to(ref.device)) / ref.lr
                for key in ref.leaves}

    def change(s):
        return {key: s[-1][key].to(ref.device) - s[0][key].to(ref.device)
                for key in ref.leaves}

    counted = tc.moved_leaves(update(r_states))
    for k, (p, r) in enumerate(zip(losses, r_losses)):
        print(f"train: step {k} loss {p!r} (reference {r!r})", file=sys.stderr)
    for name, side in (("update", update), ("change", change)):
        pn, rn = tc.norms(side(states)), tc.norms(side(r_states))
        print(f"train: {name} norms " + ", ".join(
            f"{k} {pn[k]!r} (reference {rn[k]!r})" for k in ref.leaves)
            + f"; counted {counted}", file=sys.stderr)
    loss_gap = max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(losses, r_losses))
    checks += [
        {"name": "loss_gap", "value": loss_gap, "limit": lim["loss_gap"]},
        {"name": "grad_norm_gap", "value": tc.worst_leaf_gap(update(states), update(r_states),
                                                              counted),
         "limit": lim["grad_norm_gap"]},
        {"name": "change_norm_gap", "value": tc.worst_leaf_gap(change(states), change(r_states),
                                                                counted),
         "limit": lim["change_norm_gap"]},
    ]
    return checks
