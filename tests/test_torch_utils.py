"""The port's utils against the JAX package's: pcg3d streams bit for bit,
the reference xorshift stream, and vector math to float32 rounding."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from wasm_pathtracer_tpu import config as jconfig
from wasm_pathtracer_tpu.runtime import session as jsession
from wasm_pathtracer_tpu.utils import rng as jrng
from wasm_pathtracer_tpu.utils import vecmath as jvm
from wasm_pathtracer_tpu_torch import config as tconfig
from wasm_pathtracer_tpu_torch.runtime import session as tsession
from wasm_pathtracer_tpu_torch.utils import rng as trng
from wasm_pathtracer_tpu_torch.utils import vecmath as tvm


def _u32(r, n):
    a = r.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    a[:2] = (0, 0xFFFFFFFF)
    return a


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_uniform3_bit_exact(seed):
    """Random uint32 triples, plus 0 and 2^32-1 in every argument."""
    r = np.random.default_rng(seed)
    s, i, k = _u32(r, 4096), _u32(r, 4096), _u32(r, 4096)
    ref = jrng.uniform3(s, i, k, xp=np)
    out = trng.uniform3(*(torch.from_numpy(v.astype(np.int64)) for v in (s, i, k)))
    for a, b in zip(ref, out):
        assert b.dtype == torch.float32
        np.testing.assert_array_equal(a, b.numpy())


def test_uniform3_broadcasts_scalars():
    """Python-int seed and slot against a tensor of ray ids, as the
    integrator calls it."""
    ids = np.arange(1000, dtype=np.uint32)
    ref = jrng.uniform3(np.full_like(ids, 0xBABABEBE), ids,
                        np.full_like(ids, 0x7FFF0000), xp=np)
    out = trng.uniform3(0xBABABEBE, torch.arange(1000), 0x7FFF0000)
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(a, b.numpy())


def test_uniform1_uniform2_bit_exact():
    r = np.random.default_rng(5)
    s, i, k = _u32(r, 2048), _u32(r, 2048), _u32(r, 2048)
    args = [torch.from_numpy(v.astype(np.int64)) for v in (s, i, k)]
    np.testing.assert_array_equal(trng.uniform1(*args).numpy(),
                                  jrng.uniform1(s, i, k, xp=np))
    ref, out = jrng.uniform2(s, i, k, xp=np), trng.uniform2(*args)
    assert len(out) == 2
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(a, b.numpy())


def test_debug_view_members_equal():
    assert [(m.name, int(m)) for m in tconfig.DebugView] == \
        [(m.name, int(m)) for m in jconfig.DebugView]


@pytest.mark.parametrize("seed,round_", [(0xBABABEBE, 0), (0xBABABEBE, 17),
                                         (0, 0x50000000), (0xFFFFFFFF, 3)])
def test_fold_seed_matches(seed, round_):
    assert tsession.fold_seed(seed, round_) == int(jsession.fold_seed(seed, round_))


def test_xorshift_streams_equal():
    a, b = jrng.Xorshift32(), trng.Xorshift32()
    assert [a.next_u32() for _ in range(1000)] == [b.next_u32() for _ in range(1000)]
    xs, ys = list(range(9)), list(range(9))
    a.shuffle(xs)
    b.shuffle(ys)
    assert xs == ys


def _vec(r, n=512):
    return r.normal(size=(n, 3)).astype(np.float32)


# float32 rounding of a handful of ops on O(1) values
_VM_TOL = dict(rtol=1e-5, atol=1e-6)
_VM_CASES = {
    "dot": lambda vm, a, b: vm.dot(a, b),
    "length": lambda vm, a, b: vm.length(a),
    "normalize": lambda vm, a, b: vm.normalize(a),
    "normalize_eps": lambda vm, a, b: vm.normalize(a, eps=1e-12),
    "cross": lambda vm, a, b: vm.cross(a, b),
    "reflect": lambda vm, a, b: vm.reflect(a, b),
    "rot_x": lambda vm, a, b: vm.rot_x(a, a[:, 1] * 0 + 0.54),
    "rot_y": lambda vm, a, b: vm.rot_y(a, a[:, 1] * 0 - 1.3),
    "orthogonal": lambda vm, a, b: vm.orthogonal(a),
    "tangent_frame": lambda vm, a, b: vm.tangent_frame(vm.normalize(a))[1],
}


@pytest.mark.parametrize("name", sorted(_VM_CASES))
def test_vecmath_allclose(name):
    r = np.random.default_rng(7)
    a, b = _vec(r), _vec(r)
    fn = _VM_CASES[name]
    ref = np.asarray(fn(jvm, jnp.asarray(a), jnp.asarray(b)))
    out = fn(tvm, torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(out, ref, **_VM_TOL)


OBJ = """# a quad, a triangle with negative indices, normals and texture refs
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
vn 0 0 1
f 1/1/1 2/2/1 3/3/1 4/4/1
v 0 0 2
f -1 -4 -3
"""


@pytest.mark.parametrize("scale,flip_z", [(1.0, False), (8.0, True)])
def test_obj_loader_matches_jax(tmp_path, scale, flip_z):
    from wasm_pathtracer_tpu.utils import obj as jobj
    from wasm_pathtracer_tpu_torch.utils import obj as tobj
    path = tmp_path / "m.obj"
    path.write_text(OBJ)
    ref = jobj.load_obj(str(path), scale=scale, flip_z=flip_z)
    out = tobj.load_obj(str(path), scale=scale, flip_z=flip_z)
    assert out.shape == (3, 3, 3) and out.dtype == np.float32
    np.testing.assert_array_equal(out, ref)
    assert tobj.parse_obj("v 0 0 0\n").shape == (0, 3, 3)
