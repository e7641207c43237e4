"""The frozen work count equals ``chip_smoke.py``'s on the same inputs,
so the benchmark's rooflines start from the numbers ``PERF.md`` reports
for each kernel alone."""

from __future__ import annotations

import sys

import pytest
import torch

from conftest import REPO

sys.path.insert(0, str(REPO))


@pytest.fixture(scope="module")
def museum():
    from wasm_pathtracer_tpu_torch.models import scenes
    from wasm_pathtracer_tpu_torch.models.camera import initial_camera, primary_rays
    from wasm_pathtracer_tpu_torch.ops import trace
    scene = scenes.museum(device="cpu")
    prep = trace.prepare(scene)
    g = torch.Generator().manual_seed(5)
    px = torch.randint(0, 64, (512,), generator=g)
    py = torch.randint(0, 64, (512,), generator=g)
    o, d = primary_rays(initial_camera(0, "cpu"), px, py, torch.rand(512, generator=g),
                        torch.rand(512, generator=g), 64, 64)
    return scene, prep, o.contiguous(), d.contiguous()


def test_peaks_and_flops_are_chip_smokes():
    import chip_smoke
    from portbench import workcount as wc
    assert wc.FLOPS == chip_smoke.FLOPS
    assert (wc.PEAK_FLOPS, wc.PEAK_BYTES) == (chip_smoke.PEAK_FLOPS, chip_smoke.PEAK_BYTES)
    for f, b in ((1e9, 1e6), (1e6, 1e9), (0, 0)):
        assert wc.bound(f, b) == chip_smoke.bound(f, b)


def test_scene_and_shadow_counts(museum):
    import chip_smoke
    from portbench import workcount as wc
    scene, prep, o, d = museum
    tables = prep.tables
    assert wc.scene_flops(tables, o, d) == chip_smoke.scene_flops(tables, o, d)
    t_a, ops_a = wc.torus_pairs(tables.family(3), o, d)
    t_b, ops_b = chip_smoke.torus_pairs(tables.family(3), o, d)
    assert torch.equal(t_a, t_b) and torch.equal(ops_a, ops_b)
    g = torch.Generator().manual_seed(6)
    lsid = scene.light_shape.long()[torch.randint(0, scene.num_lights, (512,), generator=g)]
    dist = torch.rand(512, generator=g) * 30
    a = wc.occluded_work(tables, prep.code_of, o, d, dist, lsid)
    b = chip_smoke.occluded_work(tables, prep.code_of, o, d, dist, lsid)
    assert a[0] == b[0] and torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])


def test_probe_counts():
    import chip_smoke
    from portbench import workcount as wc
    from wasm_pathtracer_tpu_torch.models import scenes
    from wasm_pathtracer_tpu_torch.ops import bvh, trace
    scene = scenes.select_scene(4, device="cpu")
    prep = bvh.attach_clusters(trace.prepare(scene), scene, num_bins=16, min_count=512)
    cs = prep.cluster
    g = torch.Generator().manual_seed(7)
    o = torch.rand(256, 3, generator=g)
    c1 = torch.randint(0, cs.num_clusters, (256,), generator=g, dtype=torch.int32)
    c2 = torch.randint(0, cs.num_clusters, (256,), generator=g, dtype=torch.int32)
    assert wc.probe_flops(cs, c1) == chip_smoke.probe_flops(cs, c1)
    assert wc.probe_bounds(cs, o, c1, c2) == chip_smoke.probe_bounds(cs, o, c1, c2)
