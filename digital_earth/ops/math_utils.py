"""Vectorized geometry/math primitives.

Rebuilt for batched JAX arrays from the semantics of the reference's
lib/math_utils.py. Vectors are arrays with a trailing axis of size 3 and
arbitrary leading (wavefront) batch dims; scalars broadcast against them.

Notable deviation: the reference ``rsi`` (lib/math_utils.py:18-23) takes the
sqrt *before* checking the discriminant sign, so a miss yields NaN rather
than (-1, -1); its callers only ever compare the result with ``>``/``>=``,
which NaN fails. We return a proper (-1, -1) on miss — identical observable
behavior at every call site, without NaN poisoning (which is fatal in JAX
where `jnp.where` evaluates both branches).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

EPS = 1e-4
INF = 1e10
# Every float32 einsum/matmul passes this: on a GPU, XLA may otherwise run
# them in TF32 (~3 decimal digits), and optical depths feed exp(-tau).
HIGHEST = jax.lax.Precision.HIGHEST


def sqr(x):
    return x * x


def dot(a, b):
    """Batched 3-vector dot product over the trailing axis."""
    return jnp.sum(a * b, axis=-1)


def length(v):
    return jnp.sqrt(jnp.sum(v * v, axis=-1))


def normalize(v):
    return v / jnp.maximum(length(v)[..., None], 1e-20)


def cross(a, b):
    return jnp.cross(a, b)


def saturate(x):
    return jnp.clip(x, 0.0, 1.0)


def mix(a, b, t):
    """GLSL mix: a*(1-t) + b*t (t may lie outside [0,1], as some reference
    call sites rely on — e.g. srgb_to_spectrum's negative weight)."""
    return a + (b - a) * t


def step(edge, x):
    """GLSL step: 0.0 where x < edge else 1.0."""
    return jnp.where(x < edge, 0.0, 1.0).astype(jnp.result_type(x, jnp.float32))


def smoothstep(edge0, edge1, x):
    t = saturate((x - edge0) / (edge1 - edge0))
    return t * t * (3.0 - 2.0 * t)


def cone_angle_to_solid_angle(x):
    """Solid angle of a cone of half-angle x (reference math_utils.py:14-15)."""
    return 2.0 * math.pi * (1.0 - jnp.cos(x))


def rsi(pos, direction, r):
    """Ray-sphere intersection against a sphere of radius ``r`` at the origin.

    Returns ``(t_near, t_far)`` arrays; both are -1.0 on a miss.
    Semantics match reference lib/math_utils.py:18-23 at all call sites
    (see module docstring for the NaN-on-miss fix).
    """
    b = dot(pos, direction)
    c = dot(pos, pos) - r * r
    discr = b * b - c
    sq = jnp.sqrt(jnp.maximum(discr, 0.0))
    miss = discr < 0.0
    t_near = jnp.where(miss, -1.0, -b - sq)
    t_far = jnp.where(miss, -1.0, -b + sq)
    return t_near, t_far


def sphere_uv_map(n):
    """Equirectangular UV from a unit direction (reference math_utils.py:26-28)."""
    u = (jnp.arctan2(n[..., 2], -n[..., 0]) / math.pi + 1.0) / 2.0
    v = jnp.arcsin(jnp.clip(n[..., 1], -1.0, 1.0)) / math.pi + 0.5
    return u, v


def normal_distribution(x, mean, stdev):
    return (1.0 / (stdev * math.sqrt(2.0 * math.pi))) * jnp.exp(
        -0.5 * sqr((x - mean) / stdev)
    )


def make_orthonormal_basis(n):
    """Tangent/bitangent for unit normal n (reference math_utils.py:56-60)."""
    h = jnp.where(
        (jnp.abs(n[..., 1]) > 0.9)[..., None],
        jnp.array([1.0, 0.0, 0.0], dtype=n.dtype),
        jnp.array([0.0, 1.0, 0.0], dtype=n.dtype),
    )
    y = normalize(jnp.cross(n, h))
    x = jnp.cross(n, y)
    return x, y


def spherical_direction(sin_theta, cos_theta, phi, x, y, z):
    """Direction from spherical coords in the (x, y, z) frame
    (reference math_utils.py:68-69)."""
    return (
        (sin_theta * jnp.cos(phi))[..., None] * x
        + (sin_theta * jnp.sin(phi))[..., None] * y
        + cos_theta[..., None] * z
    )


def fract(x):
    return x - jnp.floor(x)


def hash12(p):
    """Deterministic 2->1 hash (reference math_utils.py:72-75); used by the
    optional nightlight speckle shaper."""
    px, py = p[..., 0], p[..., 1]
    p3 = fract(jnp.stack([px, py, px], axis=-1) * 0.1031)
    swiz = jnp.stack([p3[..., 1], p3[..., 2], p3[..., 0]], axis=-1)
    p3 = p3 + dot(p3, swiz + 19.19)[..., None]
    return fract((p3[..., 0] + p3[..., 1]) * p3[..., 2])


def hash22(p):
    """Deterministic 2->2 hash (reference math_utils.py:77-81)."""
    px, py = p[..., 0], p[..., 1]
    p3 = fract(
        jnp.stack([px, py, px], axis=-1)
        * jnp.array([0.1031, 0.1030, 0.0973], dtype=jnp.result_type(p, jnp.float32))
    )
    swiz = jnp.stack([p3[..., 1], p3[..., 2], p3[..., 0]], axis=-1)
    p3 = p3 + dot(p3, swiz + 19.19)[..., None]
    return fract(
        jnp.stack([p3[..., 0] + p3[..., 1], p3[..., 1] + p3[..., 2]], axis=-1)
        * jnp.stack([p3[..., 2], p3[..., 1]], axis=-1)
    )


# ---------------------------------------------------------------------------
# Host-side (numpy) camera helpers, mirroring reference math_utils.py:83-102.
# ---------------------------------------------------------------------------
import numpy as _np


def np_normalize(v):
    return v / _np.sqrt(_np.sum(v**2))


def np_rotate_matrix(axis, theta):
    """4x4 rotation matrix about ``axis`` by ``theta`` radians (host side)."""
    axis = np_normalize(_np.asarray(axis, dtype=_np.float64))
    a = math.cos(theta / 2.0)
    b, c, d = -axis * math.sin(theta / 2.0)
    aa, bb, cc, dd = a * a, b * b, c * c, d * d
    bc, ad, ac, ab, bd, cd = b * c, a * d, a * c, a * b, b * d, c * d
    return _np.array(
        [
            [aa + bb - cc - dd, 2 * (bc + ad), 2 * (bd - ac), 0],
            [2 * (bc - ad), aa + cc - bb - dd, 2 * (cd + ab), 0],
            [2 * (bd + ac), 2 * (cd - ab), aa + dd - bb - cc, 0],
            [0, 0, 0, 1],
        ]
    )
