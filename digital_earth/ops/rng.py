"""Per-lane counter-based RNG.

Every random draw in the path tracer is keyed by the chain
(spp key -> global pixel id -> bounce -> site -> loop iteration) — never by
a lane's position inside a tile, a tile's index in a schedule, or a device's
mesh coordinate. Consequences:

- renders are **bit-identical under any execution layout**: tiling, stage
  compaction order, compact-tile size, and device-mesh shape all permute
  lanes without touching their random streams (the property
  tests/test_parallel.py asserts between the single-chip and multi-chip
  renderers);
- the per-lane key rides in ``TraceState.rng`` and is permuted by the stage
  compactor together with the rest of the lane state;
- it is the deterministic upgrade over the reference's stateful per-thread
  ``ti.random()`` (reference pathtracer.py:92,100 — irreproducible
  run-to-run) promised in SURVEY.md §2.4.

Cost: draws are threefry2x32 of (key, counter) pairs either way; deriving
them from per-lane keys instead of one whole-wavefront key changes which
block of counters each lane reads, not the op count per draw.

Keys are raw (..., 2) uint32 arrays (``jax.random.PRNGKey`` layout), so a
``(n, 2)`` batch gathers/scatters like any other state leaf.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def lane_keys(key, lane_ids):
    """Derive (n, 2) per-lane keys from one key and (n,) integer lane ids
    (e.g. global pixel indices — anything unique and layout-independent)."""
    return jax.vmap(lambda i: jax.random.fold_in(key, i))(lane_ids)


def as_lane_keys(key_or_keys, n: int):
    """Accept either one (2,) key (expanded over ``arange(n)`` lane ids) or
    an existing (n, 2) per-lane key batch. Lets tests/tools keep passing a
    single PRNGKey while the renderer passes pixel-derived lane keys."""
    k = jnp.asarray(key_or_keys)
    if k.ndim == 1:
        return lane_keys(k, jnp.arange(n))
    assert k.shape == (n, 2), (k.shape, n)
    return k


def fold(keys, data):
    """Fold a scalar (static or traced: bounce index, site id, iteration)
    into every key of an (n, 2) batch."""
    return jax.vmap(lambda k: jax.random.fold_in(k, data))(keys)


def uniform(keys, shape=()):
    """Per-lane uniforms: (n, 2) keys -> (*shape, n) draws.

    The lane axis goes LAST to match the (draws, k, n) layout the tracking
    loops consume."""
    u = jax.vmap(lambda k: jax.random.uniform(k, shape))(keys)  # (n, *shape)
    if shape == ():
        return u
    return jnp.moveaxis(u, 0, -1)


def _lowbias32(x):
    """Finalizing 32-bit mixer (Walker 2018 "lowbias32": xorshift-multiply
    x2; measured avalanche bias 0.17%, on par with MurmurHash3's finalizer)."""
    x = x ^ (x >> 16)
    x = x * jnp.uint32(0x7FEB352D)
    x = x ^ (x >> 15)
    x = x * jnp.uint32(0x846CA68B)
    x = x ^ (x >> 16)
    return x


def fast_uniform(keys, data, shape=()):
    """Cheap counter-based per-lane uniforms for the hot tracking loops
    (params.fast_loop_rng): (n, 2) keys + a traced scalar counter ->
    (*shape, n) draws in [0, 1).

    ``uniform(fold(keys, i), shape)`` costs one threefry fold plus one
    threefry block per 2 outputs (~40 int ops per u32), making the in-loop
    RNG the single largest op block of the tracking bodies. This replaces it with two rounds of
    lowbias32 over (key0, key1, counter, draw-index) — ~11 int ops per u32,
    same determinism/layout-independence guarantees (pure function of the
    per-lane key, which is itself threefry-derived from (spp, pixel id),
    and the loop counter). Mixing-quality note: the input already carries
    ~64 bits of threefry entropy per lane; the double lowbias32 only needs
    to decorrelate the small (counter, index) lattice, far below its
    measured avalanche quality. Used ONLY inside the accelerated trackers —
    the reference-faithful naive twins keep jax.random draws, so the
    statistical tracking-equivalence suite (tests/test_tracking_equiv.py)
    independently validates every distribution produced by this generator.
    """
    n = keys.shape[0]
    total = 1
    for s in shape:
        total *= s
    idx = jnp.arange(total, dtype=jnp.uint32).reshape(tuple(shape) + (1,))
    k0 = keys[:, 0]
    k1 = keys[:, 1]
    c = jnp.asarray(data).astype(jnp.uint32)
    x = k1[None] ^ (c * jnp.uint32(0x9E3779B9) + idx * jnp.uint32(0x85EBCA6B))
    x = _lowbias32(x)
    x = _lowbias32(x ^ k0[None])
    u = x.astype(jnp.float32) * jnp.float32(2.0**-32)
    if shape == ():
        return u[0]
    return u
