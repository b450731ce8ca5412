"""Matching parity: Hamming distances, the masked best/second search
(kernel 3's plain version) and `masked_match` with ratio, same-level and
column-unique logic, window masks, the rotation histogram, the MAD margin
gate and octave prediction, against the JAX package.

Integer outputs (distances, match indices, validity, bins) must be equal.
Inputs are built to hit the corner cases: duplicated descriptors (ties
within a row and across rows claiming one column), rows without
candidates, one-column matrices and batched masks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structure_slam_pointline_tpu.ops import hamming as jham
from structure_slam_pointline_tpu.ops import matching as jm
from structure_slam_pointline_tpu_torch.ops import hamming as tham
from structure_slam_pointline_tpu_torch.ops import matching as tm

G = np.random.default_rng(5)


def _desc(n):
    return G.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)


def _t(a):
    a = np.array(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _case(M, N, density=0.1):
    a, b = _desc(M), _desc(N)
    b[N // 2:] = b[: N - N // 2]                # equal columns -> ties
    a[: M // 4] = b[G.integers(0, N, M // 4)]   # exact and shared matches
    allow = G.uniform(size=(M, N)) < density
    allow[: min(3, M)] = False                  # rows without candidates
    return a, b, allow


def test_hamming_matrix_and_pairwise():
    a, b = _desc(70), _desc(50)
    np.testing.assert_array_equal(tham.hamming_matrix(_t(a), _t(b)).numpy(),
                                  np.asarray(jham.hamming_matrix(a, b)))
    np.testing.assert_array_equal(tham.hamming_pairwise(_t(a[:50]), _t(b)).numpy(),
                                  np.asarray(jham.hamming_pairwise(a[:50], b)))


@pytest.mark.parametrize("shape", [(64, 48), (48, 64), (7, 1), (200, 150)])
def test_masked_best2_matches_reference_reductions(shape):
    """best / best_j / re-masked second / second_j exactly as masked_match
    computes them (matching.py:57-68)."""
    a, b, allow = _case(*shape)
    D = jham.hamming_matrix(a, b)
    d = jnp.where(allow, D, jm._BIG)
    best_j = jnp.argmin(d, axis=1)
    masked2 = d + jax.nn.one_hot(best_j, shape[1], dtype=d.dtype) * jm._BIG
    ref = [jnp.min(d, axis=1), best_j, jnp.min(masked2, axis=1),
           jnp.argmin(masked2, axis=1)]
    out = tham.masked_best2(_t(a), _t(b), torch.from_numpy(allow))
    for x, y in zip(out, ref):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


@pytest.mark.parametrize("ratio,with_octave", [(1.0, False), (0.8, False), (0.9, True)])
def test_masked_match(ratio, with_octave):
    a, b, allow = _case(300, 200, density=0.2)
    oct_b = G.integers(0, 3, 200).astype(np.int32)
    ref = jm.masked_match(jham.hamming_matrix(a, b), jnp.asarray(allow), max_dist=100,
                          ratio=ratio, col_octave=jnp.asarray(oct_b) if with_octave else None)
    out = tm.masked_match(_t(a), _t(b), torch.from_numpy(allow), max_dist=100, ratio=ratio,
                          col_octave=_t(oct_b) if with_octave else None)
    np.testing.assert_array_equal(out.idx.numpy(), np.asarray(ref.idx))
    np.testing.assert_array_equal(out.dist.numpy(), np.asarray(ref.dist))
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref.valid))
    assert out.valid.sum() > 10


def test_masked_match_batched_equals_per_batch():
    """The [B, M, N] form (create_new_points / fuse) equals B separate
    reference calls, with shared or per-batch row descriptors."""
    a, b1, allow = _case(40, 30, density=0.3)
    b2 = _desc(30)
    allow2 = G.uniform(size=(40, 30)) < 0.3
    out = tm.masked_match(_t(a), _t(np.stack([b1, b2])),
                          torch.from_numpy(np.stack([allow, allow2])), max_dist=50)
    for k, (bb, al) in enumerate([(b1, allow), (b2, allow2)]):
        ref = jm.masked_match(jham.hamming_matrix(a, bb), jnp.asarray(al), max_dist=50)
        np.testing.assert_array_equal(out.idx[k].numpy(), np.asarray(ref.idx))
        np.testing.assert_array_equal(out.valid[k].numpy(), np.asarray(ref.valid))


def test_window_mask():
    uv = G.uniform(0, 100, (60, 2)).astype(np.float32)
    xy = G.uniform(0, 100, (80, 2)).astype(np.float32)
    ok, kv = G.uniform(size=60) < 0.8, G.uniform(size=80) < 0.9
    r = G.uniform(2, 30, 60).astype(np.float32)
    o1, o2 = G.integers(0, 8, 80).astype(np.int32), G.integers(0, 8, 60).astype(np.int32)
    ref = jm.window_mask(uv, ok, xy, kv, r, kp_octave=o1, pred_octave=o2)
    out = tm.window_mask(_t(uv), _t(ok), _t(xy), _t(kv), _t(r), kp_octave=_t(o1),
                         pred_octave=_t(o2))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_rotation_consistency_and_mad_gate():
    a, b, allow = _case(300, 200, density=0.2)
    ang_a = G.uniform(-np.pi, np.pi, 300).astype(np.float32)
    ang_b = G.uniform(-np.pi, np.pi, 200).astype(np.float32)
    D = jham.hamming_matrix(a, b)
    ref = jm.masked_match(D, jnp.asarray(allow), max_dist=200)
    out = tm.masked_match(_t(a), _t(b), torch.from_numpy(allow), max_dist=200)
    np.testing.assert_array_equal(
        tm.rotation_consistency(_t(ang_a), _t(ang_b), out).numpy(),
        np.asarray(jm.rotation_consistency(jnp.asarray(ang_a), jnp.asarray(ang_b), ref)))
    np.testing.assert_array_equal(
        tm.mad_margin_gate(out, 0.5).numpy(),
        np.asarray(jm.mad_margin_gate(D, jnp.asarray(allow), ref, 0.5)))


def test_predict_octave():
    dist = G.uniform(0.5, 10, 500).astype(np.float32)
    dmax = (dist * G.uniform(0.5, 6, 500)).astype(np.float32)
    np.testing.assert_array_equal(
        tm.predict_octave(_t(dist), _t(dmax), 1.2, 8).numpy(),
        np.asarray(jm.predict_octave(jnp.asarray(dist), jnp.asarray(dmax), 1.2, 8)))
