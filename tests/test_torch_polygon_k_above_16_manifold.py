"""Kernel 10 above 16 vertices: its plain version on the CPU against the
JAX package.

The cases of tests/test_torch_polygon_k_above_16.py for the contact
manifold (4-gons against 17-, 20-, 32- and 64-gons, and 32-gons against
32-gons, on the same numpy rows): kernel 10's plain version, which pads each
polygon to the kernel's bucket, against `ops.manifold.polygon_contact_manifold`
and the Pallas kernel run with ``interpret=True``: counts equal, points,
depths and normals within 2e-5 (tests/test_torch_manifold.py's bar for
kernel 10's plain version).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from collide2d_tpu.ops import manifold as jmf
from collide2d_tpu.ops import manifold_pallas as jmp
from collide2d_tpu_torch.ops import manifold_cuda as tmc
from tests.test_torch_polygon_k_above_16 import (
    BLOCK,
    KERNEL_ATOL,
    N,
    SHAPES,
    _rows,
    assert_manifolds_agree,
    jit,
)

torch.set_num_threads(1)


@pytest.mark.parametrize("k1,k2", SHAPES)
def test_kernel10_plain_vs_jnp_and_pallas(k1, k2):
    p1, p2, (a, b), (a_t, b_t) = _rows(k1, k2)
    out = tmc.polygon_manifold_cuda_t(a_t, b_t, k1=k1, k2=k2, block=BLOCK)
    got = tmc.unpack_manifold(out, N)
    want = jmp.polygon_manifold_pallas_t(a, b, k1=k1, k2=k2, block=BLOCK, interpret=True)
    assert_manifolds_agree(got, tmc.unpack_manifold(torch.from_numpy(np.array(want)), N),
                           KERNEL_ATOL)
    want_jnp = jit(jmf.polygon_contact_manifold)(jnp.asarray(p1), jnp.asarray(p2))
    assert_manifolds_agree(got, want_jnp, KERNEL_ATOL)
    counts = np.asarray(want_jnp[0])
    assert (counts == 2).any() and (counts == 0).any()
