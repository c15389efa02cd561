"""Shared helpers for the tests that hold newmsm_tpu_torch against the JAX
package: seeded numpy inputs, conversion to both frameworks, and small
comparison utilities. JAX runs on the CPU (tests/conftest.py); torch is
held to a few threads because the suite runs in several workers."""
import numpy as np
import jax.numpy as jnp
import torch

torch.set_num_threads(2)


def unit_queries(n, seed=0, radius=100.0):
    """(n,3) float32 random directions at `radius`."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 3)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return q * np.float32(radius)


def both(a, dtype=np.float32):
    """The same numpy array as (jax array, torch tensor)."""
    a = np.ascontiguousarray(np.asarray(a, dtype))
    return jnp.asarray(a), torch.from_numpy(a.copy())


def np_(x):
    """numpy view of a jax array or torch tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def warped_icosphere(res, seed=3, deg=4.0):
    """An ico-`res` mesh (radius 100) under a smooth random warp."""
    from newmsm_tpu.core.mesh import Mesh
    from newmsm_tpu.eval.synth import smooth_sphere_warp
    m = Mesh.from_icosphere(res)
    m.coords = smooth_sphere_warp(m.coords / 100.0, seed, deg) * 100.0
    return m


def bary_positions(coords, tv, w):
    """Weight-reconstructed positions sum_j w_j * coords[tv_j]."""
    return (np.asarray(coords)[np_(tv)] * np_(w)[..., None]).sum(1)



def assert_close_f32(port32, jax32, port64, rtol=2e-4, atol=1e-6):
    """Strain-like float32 values: a small strain is a difference of
    near-equal terms, so each package's float32 result is off the float64
    value by up to ~1e-4 relative (measured: 7.7e-5 for JAX on the strain
    fixtures). Both the port's float32 result and its float64 evaluation
    are held to rtol 2e-4 (atol 1e-6 for values near 0) against JAX."""
    j = np_(jax32)
    np.testing.assert_allclose(np_(port32), j, rtol=rtol, atol=atol)
    np.testing.assert_allclose(np_(port64), j, rtol=rtol, atol=atol)
