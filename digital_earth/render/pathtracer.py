"""Wavefront spectral volumetric path tracer.

This is a wavefront re-architecture of the reference megakernel
(pathtracer.py:316-469). Instead of one thread per pixel with data-dependent
control flow, a *wavefront* of N rays is advanced together:

- ray state is structure-of-arrays ((N,3) positions/directions, (N,) and
  (N,L) scalars for L-wavelength hero packets);
- the 25-bounce loop is a ``lax.while_loop`` with an ``alive`` mask and early
  exit once every lane has terminated;
- the unbounded delta-/ratio-tracking loops become masked ``while_loop``s
  drawing K speculative free-flight steps per iteration (one batched texture
  gather resolves all of them);
- the land march keeps the reference's budget/epsilon semantics but adds an
  analytic bounding-sphere cull and regional skips against a dilated
  topography max-mip carried as a second texture channel;
- cloud tracking space-skips against its own fused majorant mip; RMO
  (Rayleigh/Mie/ozone) and cloud passes stay separate as in the reference
  (pathtracer.py:186,198) — run cloud-first here so hero-packet MIS weights
  stop at the joint event — and the RMO pass needs no texture access at all;
- volume NEE and surface NEE share one merged transmittance pass per bounce,
  and all surface work is gated on any lane actually hitting land;
- each path carries a hero-wavelength packet (Wilkie et al. 2014): the hero
  drives sampling, companions ride with pdf-ratio MIS weights — ~4x the
  spectral convergence of the reference's single-wavelength estimator;
- all randomness is ``jax.random`` — deterministic and replayable.

Reference-faithful naive counterparts of every tracker live in
render/tracking_naive.py (``TraceConfig(naive_tracking=True)``); the
accelerated versions are validated against them statistically in
tests/test_tracking_equiv.py. Every stage cites the reference lines it
reproduces.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp

from .. import constants as C
from ..models import atmosphere_lut as atm
from ..models import surface as srf
from ..models import volume as vol
from ..ops import math_utils as mu
from ..ops.math_utils import HIGHEST
from ..ops import rng
from ..ops import sampling as smp
from ..ops import spectral as sp
from ..ops import texture as tx
from .params import SceneParams, TraceConfig
from . import tracking_naive as tn

NULL_EVENT = 0
ABSORB_EVENT = 1
SCATTER_EVENT = 2

# RNG site ids: each bounce's random consumers fold a distinct constant into
# the per-lane bounce key (ops/rng.py — the chain is
# spp key -> pixel -> bounce -> site -> loop iteration).
_SITE_FLIGHT = 1
_SITE_CONE = 2
_SITE_TRANS = 3
_SITE_PHASE = 4
_SITE_HEMI = 5
_SITE_RR = 6
_SITE_NEE_RR = 7
_SITE_CLOUD_RR = 8
_SUB_RMO = 1     # within a flight/transmittance site: the RMO pass
_SUB_CLOUD = 2   # within a flight/transmittance site: the cloud pass

_ALBEDOS = jnp.asarray(C.SCATTERING_ALBEDOS)

# Majorant densities: sea-level rayleigh/mie, 25 km ozone peak
# (reference pathtracer.py:336-337)
import numpy as _np  # noqa: E402

_MAX_DENS_RMO = _np.array(
    [
        float(vol.get_rayl_density(jnp.array(0.0))),
        float(vol.get_mie_density(jnp.array(0.0))),
        float(vol.get_ozone_density(jnp.array(float(C.OZONE_PEAK_HEIGHT)))),
    ],
    dtype=_np.float32,
)


# ---------------------------------------------------------------------------
# Land surface: displaced-sphere SDF (reference pathtracer.py:11-46)
# ---------------------------------------------------------------------------


def land_sdf(topo, pos, scale, bilinear=True):
    """Bump-mapped sphere SDF (reference pathtracer.py:11-14). ``topo`` is the
    2-channel (heightmap, dilated max-mip) texture; channel 0 is the height."""
    sample = tx.sample_sphere_texture(topo, pos, bilinear=bilinear)
    return mu.length(pos) - C.PLANET_R - scale * sample[..., 0]


def land_normal(topo, pos, scale, bilinear=True):
    """Finite-difference normal, 3 extra SDF taps
    (reference pathtracer.py:16-25; epsilon = pi*planet_r/tex_width)."""
    d = land_sdf(topo, pos, scale, bilinear)
    e = math.pi * C.PLANET_R / topo.w
    ex = jnp.array([e, 0.0, 0.0])
    ey = jnp.array([0.0, e, 0.0])
    ez = jnp.array([0.0, 0.0, e])
    n = jnp.stack(
        [
            d - land_sdf(topo, pos - ex, scale, bilinear),
            d - land_sdf(topo, pos - ey, scale, bilinear),
            d - land_sdf(topo, pos - ez, scale, bilinear),
        ],
        axis=-1,
    )
    return mu.normalize(n)


# Validity radii of the two topography max-mips (assets/textures.py
# MIP_*_VALID_KM): a mip tap bounds the displacement within these distances.
_MIP_VALID_FINE = 25e3
_MIP_VALID_COARSE = 115e3

# Line-perigee altitude above which the reference's h=0 crawl provably
# cannot phantom-hit (see _phantom_crawl): dense sweep puts budget
# exhaustion below 1913 m and the in-cap epsilon stop below 6371 m; 16 km
# is a 2.5x margin. tests/test_tracking_equiv.py sweeps the band above it.
_PHANTOM_PRUNE_ALT = 16e3


def _run_narrowed(cond, make_body, ctx, init, done_index, cfg: TraceConfig,
                  wide_cap=None):
    """Run a masked per-lane while_loop with straggler narrowing.

    Every hot loop in this module is per-lane element-wise: a lane's next
    state depends only on its own state, the loop's shared scalar iteration
    counter, and per-lane closed-over context — so after a few full-width
    iterations the few still-live stragglers can be compacted into a
    ``cfg.loop_narrow``-lane buffer and finished there, bit-identically.
    Per-iteration cost (the batched texture gather + select math + carry)
    can scale with lane width while the trip count is set by the WORST
    lane (p99 of march lanes finish in <=2 sweeps; the stragglers drag the
    whole tile through up to 16), so the straggler tail can run
    ~width/narrow times cheaper.

    cond: width-agnostic loop condition ((i < budget) & jnp.any(~done)).
    make_body: ctx-pytree -> loop body; ctx leaves are (n, ...) per-lane
        arrays the body closes over (rays, keys, bounds). Lane-independent
        values (textures, configs, scalars) must stay closed over in
        make_body itself — the helper only re-indexes ctx and state leaves
        whose leading axis is the lane axis.
    init: loop carry; leaves are scalars or (n, ...) per-lane arrays, with
        the (n,) done mask at ``done_index``.
    wide_cap: iteration-counter value at which to narrow (defaults to
        ``cfg.loop_narrow_after``; the march counts probes, not sweeps).
    If more than loop_narrow lanes are live at the switch, that call
    finishes at full width instead (lax.cond, decided per tile at runtime).
    """
    n = init[done_index].shape[0]
    narrow = cfg.loop_narrow
    if not narrow or narrow >= n:
        return jax.lax.while_loop(cond, make_body(ctx), init)

    cap = cfg.loop_narrow_after if wide_cap is None else wide_cap
    body = make_body(ctx)
    state = jax.lax.while_loop(
        lambda s: (s[0] < cap) & cond(s), body, tuple(init)
    )
    done = state[done_index]
    undone = ~done
    n_undone = jnp.sum(undone)

    def is_lane(a):
        return getattr(a, "ndim", 0) >= 1 and a.shape[0] == n

    def narrow_path(state):
        rank = jnp.cumsum(undone) - 1
        dest = jnp.where(undone, rank, narrow).astype(jnp.int32)
        slot_src = jnp.zeros((narrow,), jnp.int32).at[dest].set(
            jnp.arange(n, dtype=jnp.int32), mode="drop"
        )
        slot_live = jnp.arange(narrow) < n_undone
        gidx = jnp.where(slot_live, slot_src, 0)
        take = lambda a: a[gidx] if is_lane(a) else a
        st_n = jax.tree_util.tree_map(take, state)
        # pad slots replay lane 0 but are marked done (masked out of the
        # loop) and their results are dropped by the out-of-range scatter
        st_n = (
            st_n[:done_index]
            + (st_n[done_index] | ~slot_live,)
            + st_n[done_index + 1:]
        )
        st_n = jax.lax.while_loop(
            cond, make_body(jax.tree_util.tree_map(take, ctx)), st_n
        )
        sidx = jnp.where(slot_live, gidx, n).astype(jnp.int32)

        def put(a, b):
            return a.at[sidx].set(b, mode="drop") if is_lane(a) else b

        return jax.tree_util.tree_map(put, state, st_n)

    def wide_path(state):
        return jax.lax.while_loop(cond, body, state)

    return jax.lax.cond(n_undone <= narrow, narrow_path, wide_path, state)



def intersect_land(topo, pos, direction, scale, active, cfg: TraceConfig,
                   t_cap=None, any_hit=False, floor_frac=None):
    """Sphere-march against the displaced sphere with regional analytic skips.

    Semantics follow reference pathtracer.py:27-46 (march budget, relative
    epsilon |d| < t*1e-4, hit-if-unconverged-at-cap, 10-planet-radii cap),
    redesigned for the wavefront:

    - analytic cull + bracket: rays missing the bounding sphere of the
      displaced surface (radius planet_r + height_scale) never march; the
      march starts at the bounding-sphere entry and is a miss once the ray
      leaves the bounding shell;
    - two-level regional skips: each tap of the 4-channel topography texture
      also returns dilated maxes of the heightmap at two scales (~20 km
      cells valid within 25 km, ~156 km cells valid within 115 km). Within a
      mip's validity radius the terrain lies below radius planet_r +
      scale*mip_max, so the ray may safely advance to its analytic
      intersection with that sphere (or the full validity radius when it
      misses); the step takes the better of the two certified skips. Grazing
      limb rays over ocean ride the coarse level ~100 km per tap, and rays
      over lowlands near mountains ride the fine level instead of crawling
      at SDF scale;
    - a step floor of a quarter texel arc (features narrower than a texel
      cannot exist in the bilinear heightfield);
    - reference-style negative-SDF backtrack (a probe inside the terrain
      retreats by its SDF, oscillating onto the boundary);
    - *stall termination*: the heightfield SDF is only a radial bound, so a
      lane on steep terrain can overshoot, retreat, and oscillate around the
      boundary without ever meeting the relative epsilon — measured 1.3% of
      lanes on an Apollo wavefront, but they run the full 250-probe budget
      and the whole tile's while_loop paces its worst lane (99% of lanes
      finish within ~8 probes; the stuck 1.3% cost ~5x march time). A lane
      that makes less than a quarter step-floor of forward progress over two
      consecutive sweeps is oscillating at the surface and terminates as a
      hit at its current t — the same outcome the reference's
      hit-if-unconverged-at-budget semantics (pathtracer.py:46) assigns it
      ~60 iterations later, with sub-texel t difference (validated by the
      tracking-equivalence and golden tests);
    - *speculative K-probe stepping*: each iteration places K probes at the
      lane's adaptive stride (last applied step) and resolves them with ONE
      batched texture gather. A probe chains to the next only while its
      certified free distance covers the stride, so grazing terrain-parallel
      lanes retire K quarter-texel steps per iteration and open-ocean lanes
      retire K ~100 km skips — quartering the dominant per-iteration fixed
      costs (gather latency + loop bookkeeping) in both regimes.

    ``any_hit``: occlusion-only queries (surface-NEE shadow rays,
    reference pathtracer.py:422) need a binary answer, not the boundary
    parameter — a probe that lands inside the terrain (f < 0) terminates
    the lane as a hit immediately instead of backtracking onto the
    boundary and grinding the relative epsilon, and the oscillation-stall
    machinery is moot. Identical hit/miss outcome (any lane that ever
    penetrates would converge to a hit; the epsilon-converged and
    budget-exhausted cases count as hits in both modes), fewer worst-lane
    iterations.

    Returns hit distance, -1.0 on miss.
    """
    n = pos.shape[0]
    if not cfg.enable_land:
        return jnp.full((n,), -1.0)
    k = cfg.march_k
    arange_k = jnp.arange(k)[:, None].astype(jnp.float32)
    # Step floor: a fraction of a texel arc. The floor is the march's ONLY
    # uncertified step (f-steps detect penetration by sign, regional skips
    # are certified), so its size is the tunneling window: a grazing ray
    # can hop a terrain crossing narrower than the floor without either
    # probe dipping inside (measured as a -12% whole-image bias vs the
    # floor-free naive march at 1024-res textures where the floor is
    # 2.4 km; see docs/PARITY.md bisection). cfg.march_floor_frac trades
    # worst-lane iteration count against that window. ``floor_frac``
    # overrides it (traced scalar: the bounce loop passes the tighter
    # secondary floor for bounce > 0, params.march_floor_frac_secondary).
    if floor_frac is None:
        floor_frac = cfg.march_floor_frac
    texel_arc = math.pi * C.PLANET_R / topo.w
    step_floor = texel_arc * floor_frac
    step_floor_uncert = texel_arc * cfg.march_uncert_floor_frac

    bound_near, bound_far = mu.rsi(pos, direction, C.PLANET_R + scale)
    may_hit = active & (bound_far > 0.0)
    t0 = jnp.maximum(bound_near, 0.0)
    max_ray_dist = C.PLANET_R * 10.0
    miss_beyond = jnp.minimum(bound_far + 1.0, max_ray_dist)
    if t_cap is not None:
        # a free-flight event at t_cap truncates the march: anything beyond
        # it is the volume event's business, not the surface's
        miss_beyond = jnp.minimum(miss_beyond, t_cap)
        may_hit = may_hit & (t0 < t_cap)

    def cond(s):
        i, _, _, done, _, _ = s
        return (i < cfg.land_march_steps) & jnp.any(~done)

    if cfg.scalar_ray_geom:
        # per-lane ray constants (see params.scalar_ray_geom): every probe
        # quantity below is a scalar function of the probe parameter ts.
        # h2 (squared perigee radius) from the cross product, which stays
        # well-conditioned in f32 where |pos|^2 - (pos.dir)^2 cancels
        # (same trick as atmosphere_lut._ray_perigee). They ride in ctx so
        # _run_narrowed can re-index them per lane.
        b0_c = mu.dot(pos, direction)
        cr = jnp.cross(pos, direction)
        h2_c = jnp.sum(cr * cr, axis=-1)
        base_disc = C.PLANET_R * C.PLANET_R - h2_c
        base_miss_c = base_disc < 0.0
        base_near_abs_c = -b0_c - jnp.sqrt(jnp.maximum(base_disc, 0.0))
        full_ctx = (pos, direction, miss_beyond, b0_c, h2_c, base_miss_c,
                    base_near_abs_c)
    else:
        full_ctx = (pos, direction, miss_beyond, None, None, None, None)

    # validity radii of the three packed mip bounds (fine 25 km,
    # coarse 115 km, tight 8 km), stacked for the fused skip computation
    _valid3 = jnp.array(
        [_MIP_VALID_FINE, _MIP_VALID_COARSE, _CLOUD_VALID], jnp.float32
    )[:, None, None]

    def make_body(ctx):
        pos, direction, miss_beyond, b0, h2, base_miss, base_near_abs = ctx

        def body(s):
            i, t, stride, done, missed, stall = s
            ts = t[None, :] + arange_k * stride[None, :]  # (k, n) probe params
            # One shared ray quadratic per probe feeds |ro|, all three
            # regional-skip sphere tests AND the exact-ocean base-sphere
            # root (fusion-group diet: where the loop's cost is bound by the
            # count of emitted ops, 4 separate rsi calls + 3 separate skip
            # selects collapse into one stacked (3, k, n) computation with
            # a single sqrt each).
            if cfg.scalar_ray_geom:
                b = b0[None, :] + ts                # dot(ro, dir) per probe
                h2b = h2[None, :]                   # (1, n) squared perigee
                rlen = jnp.sqrt(h2b + b * b)        # |ro| (no cancellation)
                sample = tx.sample_ray_texture(
                    topo, pos, direction, ts, rlen,
                    bilinear=cfg.bilinear_tracking,
                )
            else:
                ro = pos[None] + ts[..., None] * direction[None]
                sample = tx.sample_sphere_texture(
                    topo, ro, bilinear=cfg.bilinear_tracking
                )
                rr = jnp.sum(ro * ro, axis=-1)                   # (k, n)
                b = jnp.sum(ro * direction[None], axis=-1)       # (k, n)
                # squared perigee via the cross product: rr - b*b cancels
                # catastrophically in f32 at planet scale (same trick as
                # atmosphere_lut._ray_perigee / the scalar branch above)
                cr = jnp.cross(ro, jnp.broadcast_to(direction[None], ro.shape))
                h2b = jnp.sum(cr * cr, axis=-1)                  # (k, n)
                rlen = jnp.sqrt(rr)
            f = rlen - C.PLANET_R - scale * sample[..., 0]

            # certified regional skips against the three mip-bound spheres:
            # rsi with the shared quadratic — disc = r^2 - h2, roots -b -+ sq
            mips = jnp.moveaxis(sample[..., 1:4], -1, 0)         # (3, k, n)
            r_bound = C.PLANET_R + scale * mips
            disc = r_bound * r_bound - h2b[None]
            sq = jnp.sqrt(jnp.maximum(disc, 0.0))
            miss3 = disc < 0.0
            near3 = jnp.where(miss3, -1.0, -b[None] - sq)
            far3 = jnp.where(miss3, -1.0, -b[None] + sq)
            s_region = jnp.max(
                jnp.where(
                    near3 > 0.0,
                    jnp.minimum(near3, _valid3),
                    jnp.where(far3 < 0.0, _valid3, 0.0),
                ),
                axis=0,
            )  # (k, n)
            if cfg.march_certified_floor:
                # Certified floor hop (params.march_certified_floor): the
                # hop [ts, ts + floor] cannot cross terrain if the ray's
                # minimum radius over the segment clears ANY regional bound
                # sphere whose validity covers the hop. min |ro(s)| over
                # s in [0, floor] is analytic on the shared quadratic:
                # attained at s=0 while ascending (b >= 0), at s=floor while
                # descending throughout (b + floor <= 0), at the perigee
                # (sqrt h2) otherwise. Uncertified probes — ray below every
                # regional max, the only geometry where tunneling can
                # happen — fall back to the small uncertified floor.
                b_end = b + step_floor
                min_r2 = h2b + jnp.where(
                    b >= 0.0,
                    b * b,
                    jnp.where(b_end <= 0.0, b_end * b_end, 0.0),
                )
                cert = jnp.any(
                    (min_r2[None] > r_bound * r_bound)
                    & (step_floor < _valid3),
                    axis=0,
                )  # (k, n)
                floor_eff = jnp.where(cert, step_floor, step_floor_uncert)
            else:
                floor_eff = step_floor
            step = jnp.where(
                f < 0.0, f, jnp.maximum(jnp.maximum(f, s_region), floor_eff)
            )  # (k, n)
            # Exact analytic ocean hit: a ZERO regional max (the displacement is
            # uint8 >= 0, so zero max means the terrain IS the base sphere
            # throughout the bound's validity ball) turns the probe's
            # base-sphere intersection into the exact surface hit — no
            # floor-step crawl to the relative epsilon. Grazing rays over open
            # ocean (most of an Apollo/florida frame) terminate on their first
            # in-ball probe; exact, so strictly tighter than the march's
            # |f| < t*1e-4 convergence slack.
            if cfg.scalar_ray_geom:
                # base-sphere root hoisted out of the loop: the near root
                # relative to probe j is just (absolute root) - ts
                p_near = jnp.where(
                    base_miss[None, :], -1.0, base_near_abs[None, :] - ts
                )
            else:
                pdisc = C.PLANET_R * C.PLANET_R - h2b
                p_near = jnp.where(
                    pdisc < 0.0, -1.0,
                    -b - jnp.sqrt(jnp.maximum(pdisc, 0.0)),
                )

            if cfg.march_exact_ocean:
                ocean_hit = jnp.any(
                    (mips <= 0.0)
                    & (p_near[None] > 0.0) & (p_near[None] <= _valid3),
                    axis=0,
                )
            else:  # parity bisection (params.march_exact_ocean)
                ocean_hit = jnp.zeros(ts.shape, bool)
            converged = jnp.abs(f) < ts * 1e-4
            # the converged probe's parameter: the exact base-sphere hit for
            # ocean terminations, the probe position otherwise
            t_conv = jnp.where(converged, ts, ts + p_near)
            converged = converged | ocean_hit
            if any_hit:
                converged = converged | (f < 0.0)
                t_conv = jnp.where(f < 0.0, ts, t_conv)
            out = ts > miss_beyond[None, :]
            # probe j stops the sweep if it terminates (converged/left the shell)
            # or cannot certify the stride to probe j+1
            terminal = converged | out
            stop_k = terminal | (step < stride[None, :])
            any_stop = jnp.any(stop_k, axis=0)
            first = jnp.argmax(stop_k, axis=0)
            pick = (arange_k == first[None, :].astype(jnp.float32)).astype(step.dtype)
            psel = lambda a: jnp.sum(a * pick, axis=0)

            t_stop = psel(jnp.where(converged, t_conv, ts))
            step_stop = psel(step)
            conv_stop = psel(converged.astype(step.dtype)) > 0.5
            out_stop = psel(out.astype(step.dtype)) > 0.5
            # stopped lanes: converged stay at the (exact-or-probe) parameter;
            # short-steppers advance (or retreat) by their own step. Full sweeps
            # take the last probe's full step on top of the chained strides.
            t_stopped = jnp.where(conv_stop | out_stop, t_stop, t_stop + step_stop)
            t_full = ts[-1] + step[-1]
            t_new = jnp.where(any_stop, t_stopped, t_full)
            applied = jnp.where(any_stop, step_stop, step[-1])
            # stride clamps to the smallest legitimate step so uncertified
            # lanes chain probes at their actual pace (probes whose step
            # undershoots the stride stop the sweep anyway — no tunneling)
            stride_new = jnp.maximum(
                applied,
                step_floor_uncert if cfg.march_certified_floor else step_floor,
            )

            newly_done = any_stop & (conv_stop | out_stop)
            missed = missed | ((~done) & any_stop & out_stop & ~conv_stop)
            t_next = jnp.where(done, t, jnp.where(newly_done, t_stop, t_new))
            # stall termination: oscillating boundary lanes (see docstring)
            # (threshold rides the smallest legitimate floor: lanes pacing
            # at the uncertified floor are progressing, not oscillating)
            stall_thresh = (
                step_floor_uncert if cfg.march_certified_floor else step_floor
            ) * 0.25
            stalled_now = (~done) & (~newly_done) & (
                t_next - t < stall_thresh
            )
            stall = jnp.where(stalled_now, stall + 1, 0)
            # terminate as a hit at the current t (patience knob: params)
            stuck = stall >= cfg.march_stall_patience
            stride = jnp.where(done | newly_done | stuck, stride, stride_new)
            done = done | newly_done | stuck
            return i + k, t_next, stride, done, missed, stall

        return body

    init = (
        jnp.int32(0), t0, jnp.full((n,), step_floor), ~may_hit, ~may_hit,
        jnp.zeros((n,), dtype=jnp.int32),
    )
    _, t, _, _, missed, _ = _run_narrowed(
        cond, make_body, full_ctx, init,
        done_index=3, cfg=cfg,
        wide_cap=cfg.loop_narrow_after * k,  # the march counts probes
    )
    # reference semantics: anything that neither left the shell nor exceeded
    # the cap distance counts as a hit (pathtracer.py:46)
    result = jnp.where((~missed) & (t < max_ray_dist), t, -1.0)
    if cfg.march_ref_phantom:
        result = _phantom_crawl(
            pos, direction, active, result, t_cap, cfg
        )
    return result


def _phantom_crawl(pos, direction, active, result, t_cap, cfg):
    """Reference budget-exhaustion 'phantom' hits (params.march_ref_phantom).

    The reference march (pathtracer.py:27-46) never checks the displaced
    surface's bounding shell: a near-tangent ray that misses (or exits) the
    terrain crawls f-steps toward the 10-planet-radii cap, and if its 250-step
    budget runs out first — perigee altitudes under ~1 km burn hundreds of
    sub-km steps climbing out of the perigee well — the reference counts it
    as a LAND HIT at wherever the crawl stopped (up to tens of thousands of
    km above the surface) and shades terrain there. The wavefront march
    correctly misses these lanes, which round 4's instrumentation measured
    as the naive-only hit population (0.10% of florida bounce-0 lanes,
    two-thirds over ocean) behind the florida R +1.4% parity residual
    (docs/PARITY.md round 5).

    This emulates the reference crawl for the march's miss lanes with the
    terrain term dropped (h = 0): gather-free, so each of the reference's
    250 steps is a few fused elementwise ops via the scalar ray quadratic
    t' = t + sqrt(h2 + (b0+t)^2) - planet_r, 8 steps unrolled per while
    iteration. Exact over ocean (topography is 0 there); over land skims the
    naive crawl's in-shell steps are shorter (h > 0), so the emulated budget
    is slightly generous — the residual is the sliver of lanes whose
    phantom/escape outcome flips within that slack."""
    b0 = mu.dot(pos, direction)
    cr = jnp.cross(pos, direction)
    h2 = jnp.sum(cr * cr, axis=-1)
    a_near, _ = mu.rsi(pos, direction, C.ATMOS_UPPER_LIMIT)
    t0 = jnp.where(a_near > 0.0, a_near, 0.0)
    max_ray_dist = C.PLANET_R * 10.0
    # Provable phantom pruning: the crawl is h=0 pure geometry, so its
    # outcome is a function of (perigee altitude, start offset) alone. A
    # dense 2000-step sweep of that 2-D space (tools note in
    # tests/test_tracking_equiv.py::test_phantom_prune_threshold_provable)
    # shows budget exhaustion is possible only below 1913 m line-perigee
    # altitude, and the relative-epsilon stop (|dist| < t*1e-4) can fire
    # inside the 10-planet-radii cap only below 1e-4*10R = 6371 m. Above
    # 16 km (2.5x margin) a miss lane provably escapes un-phantomed, and
    # the while_loop's any(~done) retires non-limb tiles in one test —
    # the crawl's cost concentrates on the limb ring where the reference
    # actually pays it.
    perigee_alt = jnp.sqrt(h2) - C.PLANET_R
    need = active & (result < 0.0) & (perigee_alt < _PHANTOM_PRUNE_ALT)

    def cond(s):
        i, _, done = s
        return (i < cfg.land_march_steps) & jnp.any(~done)

    def body(s):
        i, t, done = s
        for _ in range(8):
            b = b0 + t
            dist = jnp.sqrt(h2 + b * b) - C.PLANET_R
            t_new = t + dist
            stop = (t_new > max_ray_dist) | (jnp.abs(dist) < t_new * 1e-4)
            t = jnp.where(done, t, t_new)
            done = done | stop
        return i + 8, t, done

    _, t_ph, _ = jax.lax.while_loop(cond, body, (jnp.int32(0), t0, ~need))
    phantom = need & (t_ph < max_ray_dist)
    if t_cap is not None:
        # a free-flight event before the phantom parameter wins, exactly as
        # it truncates the real march
        phantom = phantom & (t_ph < t_cap)
    return jnp.where(phantom, t_ph, result)


# ---------------------------------------------------------------------------
# Participating-media densities (reference pathtracer.py:48-71)
# ---------------------------------------------------------------------------


_CLOUD_SPLIT = 0.2  # split-shape anchor height fraction (reference :59)


def _cloud_shape_density(cloud_texture, r):
    """Cloud density from the column-height sample and radius
    (reference pathtracer.py:48-65): split-shape slab occupancy."""
    in_slab = (r > C.CLOUDS_LOWER_LIMIT) & (r < C.CLOUDS_UPPER_LIMIT)
    h = (r - C.CLOUDS_LOWER_LIMIT) / C.CLOUDS_THICKNESS
    split = _CLOUD_SPLIT
    shape_on = (h - split < cloud_texture * (1.0 - split)) & (
        split - h < cloud_texture * split
    )
    density = jnp.where(in_slab & shape_on, jnp.maximum(cloud_texture, 0.4), 0.0)
    return density * C.CLOUDS_DENSITY


def _cloud_band_radii(mip):
    """Occupied radial band [r_lo, r_hi] implied by a regional max column
    height ``mip``: the split shape is on only for height fractions
    h in (split*(1-tex), split + tex*(1-split)), so the regional max bounds
    the band. Everything radially outside it is certified empty within the
    mip's validity radius — the lever that lets grazing sun chords skip the
    2D-cloudy-but-radially-empty airspace they otherwise Woodcock-crawl."""
    lo = C.CLOUDS_LOWER_LIMIT + C.CLOUDS_THICKNESS * _CLOUD_SPLIT * (1.0 - mip)
    hi = C.CLOUDS_LOWER_LIMIT + C.CLOUDS_THICKNESS * (
        _CLOUD_SPLIT + mip * (1.0 - _CLOUD_SPLIT)
    )
    return lo, hi


def get_clouds_density(clouds_tex, pos, bilinear=True):
    """Cloud slab density at a position (reference pathtracer.py:48-65).
    ``clouds_tex`` is the 4-channel (map, tight mip, coarse mip, wide mip)
    texture (assets/textures.with_mips); channel 0 is the column-height
    map."""
    sample = tx.sample_sphere_texture(clouds_tex, pos, bilinear=bilinear)
    return _cloud_shape_density(sample[..., 0], mu.length(pos))


# ---------------------------------------------------------------------------
# Delta tracking & ratio tracking (reference pathtracer.py:77-143)
# ---------------------------------------------------------------------------


def _delta_track_rmo(
    keys, ray_pos, ray_dir, t_start, t_max, extinctions, max_extinction,
    active, cfg: TraceConfig,
):
    """Woodcock/delta tracking of a free-flight interaction with the
    Rayleigh/Mie/ozone gases (reference pathtracer.py:77-115; purely analytic
    densities — no texture access). Each loop iteration draws K speculative
    free-flight steps at once and resolves the first terminal one.

    The majorant is *local*: each iteration rebuilds it from the density
    envelopes (models/atmosphere_lut.density_envelope) at the minimum
    altitude of the *remaining* segment, so a ray high in the atmosphere
    steps at its local mean free path instead of the sea-level one the
    reference uses globally (pathtracer.py:336-337) — orders of magnitude
    fewer null collisions for space/limb rays, still exactly unbiased
    (exponential memorylessness permits majorant switches between steps).

    Hero-wavelength aware: ``extinctions`` is (n, L, 3); sampling decisions
    (distances, species, scatter-vs-absorb) are driven by the hero wavelength
    (index 0), so the local majorant only needs to bound the *hero*
    extinction. Companion weights are NOT accumulated per collision (the
    per-collision likelihood-ratio product explodes when a tight majorant
    makes the hero's null probability small); the *marginal* event pdf ratio
    is computed in closed form afterwards (see spectral_flight_weights),
    which is the conditional expectation of the per-collision product — same
    estimator in expectation, strictly lower variance, exact per member.

    Returns (event, t, interaction_id).
    """
    n = t_start.shape[0]
    L = extinctions.shape[1]
    k = cfg.tracking_k
    keys = rng.as_lane_keys(keys, n)
    valid = active & (t_max >= 0.0) & (t_start < t_max)
    t_max_safe = jnp.maximum(t_max, 0.0)
    arange_k = jnp.arange(k)[:, None]
    ext_h = extinctions[:, 0, :]  # (n, 3) hero extinction coefficients
    # perigee frame of each ray, for remaining-segment minimum altitudes
    rp, xp = atm._ray_perigee(ray_pos, ray_dir)
    x_end = t_max_safe + xp

    def cond(s):
        i, done = s[0], s[2]
        return (i < cfg.max_tracking_steps) & jnp.any(~done)

    draw = rng.fast_uniform if cfg.fast_loop_rng else (
        lambda ks, i, shape: rng.uniform(rng.fold(ks, i), shape)
    )

    def make_body(ctx):
        keys, ray_pos, ray_dir, t_max, t_max_safe, ext_h, rp, xp, x_end = ctx

        def body(s):
            i, t, done, event, iid = s
            u = draw(keys, i, (3, k))  # (3, k, n)
            # local hero majorant over the remaining segment [t, t_max]
            r_min = atm.segment_min_radius(rp, t + xp, x_end)
            env = atm.density_envelope(r_min - C.PLANET_R)  # (n, 3)
            inv_max = 1.0 / jnp.maximum(jnp.sum(ext_h * env, axis=-1), 1e-20)
            steps = -jnp.log(jnp.maximum(u[0], 1e-12)) * inv_max  # (k, n)
            ts = t[None, :] + jnp.cumsum(steps, axis=0)
            if cfg.scalar_ray_geom:
                # elevation from the perigee frame already in ctx: |ro| =
                # hypot(rp, x) — no (k, n, 3) positions (scalar_ray_geom)
                x = xp[None, :] + jnp.minimum(ts, t_max_safe)
                rlen = jnp.sqrt(rp[None, :] * rp[None, :] + x * x)
                dens = vol.get_density(rlen - C.PLANET_R)  # (k, n, 3)
            else:
                pos = ray_pos[None] + jnp.minimum(ts, t_max_safe)[..., None] * ray_dir[None]
                dens = vol.get_density(vol.get_elevation(pos))  # (k, n, 3)
            total_h = jnp.einsum("knc,nc->kn", dens, ext_h, precision=HIGHEST)
            over_k = ts >= t_max
            real_k = u[1] < total_h * inv_max
            stop_k = over_k | real_k
            any_stop = jnp.any(stop_k, axis=0)
            first = jnp.argmax(stop_k, axis=0)  # first terminal probe
            pick = (arange_k == first[None, :]).astype(ts.dtype)
            psel = lambda a: jnp.sum(a * pick, axis=0)
            t_sel = jnp.where(any_stop, psel(ts), ts[-1])
            over = psel(over_k.astype(ts.dtype)) > 0.5
            # species CMF over (rayleigh, mie, ozone) at the stopping probe,
            # decided by the hero extinctions (reference pathtracer.py:102-106)
            ext_stop = jnp.einsum(
                "kn,knc->nc", pick, dens, precision=HIGHEST
            ) * ext_h  # (n, 3)
            r = psel(u[1]) / inv_max
            c0 = ext_stop[:, 0]
            c01 = c0 + ext_stop[:, 1]
            iid_new = jnp.where(
                r < c0, C.RAYLEIGH_ID, jnp.where(r < c01, C.MIE_ID, C.OZONE_ID)
            )
            # albedo Russian roulette: scatter vs absorb
            # (reference pathtracer.py:108-111, 263-270)
            scatters = psel(u[2]) < _ALBEDOS[iid_new]
            hit = (~done) & any_stop & (~over)
            event = jnp.where(
                hit, jnp.where(scatters, SCATTER_EVENT, ABSORB_EVENT), event
            )
            iid = jnp.where(hit, iid_new, iid)
            t = jnp.where(done, t, t_sel)
            done = done | ((~done) & any_stop)
            return i + 1, t, done, event, iid

        return body

    init = (
        jnp.int32(0),
        t_start,
        ~valid,
        jnp.full((n,), NULL_EVENT, dtype=jnp.int32),
        jnp.zeros((n,), dtype=jnp.int32),
    )
    _, t, _, event, iid = _run_narrowed(
        cond, make_body,
        (keys, ray_pos, ray_dir, t_max, t_max_safe, ext_h, rp, xp, x_end),
        init, done_index=2, cfg=cfg,
    )
    return event, t, iid


def _sample_rmo_flight_analytic(
    keys, ray_pos, ray_dir, t_start, t_max, ext_rmo, active, cfg: TraceConfig
):
    """RMO free-flight event by exact CDF inversion
    (atmosphere_lut.sample_flight_distance) — distribution-identical to
    delta tracking (reference pathtracer.py:77-115) but with a fixed
    iteration count and no per-step RNG. Species selection by the local
    extinction CMF (reference pathtracer.py:102-106) and albedo Russian
    roulette (reference pathtracer.py:108-111) are unchanged.

    Returns (event, t, interaction_id) like _delta_track_rmo."""
    n = ray_pos.shape[0]
    ext_h = ext_rmo[:, 0, :]
    u = rng.uniform(rng.as_lane_keys(keys, n), (3,))  # (3, n)
    t, collided, _ = atm.sample_flight_distance(
        u[0], ray_pos, ray_dir, t_start, t_max, ext_h,
        n_iter=cfg.flight_newton_iters,
    )
    collided = collided & active
    h = vol.get_elevation(ray_pos + t[:, None] * ray_dir)
    ext_stop = vol.get_density(h) * ext_h  # (n, 3)
    c0 = ext_stop[:, 0]
    c01 = c0 + ext_stop[:, 1]
    r = u[1] * jnp.maximum(c01 + ext_stop[:, 2], 1e-30)
    iid = jnp.where(
        r < c0, C.RAYLEIGH_ID, jnp.where(r < c01, C.MIE_ID, C.OZONE_ID)
    )
    scatters = u[2] < _ALBEDOS[iid]
    event = jnp.where(
        collided,
        jnp.where(scatters, SCATTER_EVENT, ABSORB_EVENT),
        NULL_EVENT,
    )
    iid = jnp.where(collided, iid, 0)
    return event, t, iid


def spectral_flight_weights(
    ray_pos, ray_dir, t_start, t_end, extinctions, iid, rmo_collision, active
):
    """Closed-form hero-packet MIS weight for this bounce's flight outcome.

    The marginal pdf ratio of the observed outcome under wavelength j vs the
    hero (Wilkie et al. 2014 spectral MIS):

        escape / surface hit / cloud event at t:  exp(-(tau_j - tau_h)(t))
        RMO collision of species s at t:  (k_s(lambda_j) / k_s(lambda_h))
                                           * exp(-(tau_j - tau_h)(t))

    (species density cancels; cloud extinction is wavelength-flat so cloud
    events carry only the RMO transmittance ratio). tau differences come
    from the density-integral table — exact, zero extra variance.
    ``t_end`` is the effective endpoint: event distance, land hit, or the
    RMO span end for escapes. Returns (n, L)."""
    t_end = jnp.maximum(t_end, t_start)
    d_seg = atm.density_integral_segment(ray_pos, ray_dir, t_start, t_end)
    tau = jnp.einsum("nlc,nc->nl", extinctions, d_seg, precision=HIGHEST)
    w = jnp.exp(-(tau - tau[:, :1]))
    sp_pick = jax.nn.one_hot(jnp.minimum(iid, 2), 3, dtype=w.dtype)
    k_sp = jnp.einsum("nlc,nc->nl", extinctions, sp_pick, precision=HIGHEST)
    sp_ratio = k_sp / jnp.maximum(k_sp[:, :1], 1e-20)
    w = jnp.where(rmo_collision[:, None], w * sp_ratio, w)
    return jnp.where(active[:, None], w, 1.0)


def _ratio_track_rmo(
    keys, ray_pos, ray_dir, t_start, t_max, extinctions, max_extinction,
    active, cfg: TraceConfig,
):
    """Residual ratio tracking of RMO transmittance
    (reference pathtracer.py:117-143), K speculative steps per iteration.
    ``extinctions`` is (n, L, 3): one shared free-flight stream (driven by
    the packet majorant) estimates the transmittance of every wavelength at
    once. Returns (n, L)."""
    n = t_start.shape[0]
    L = extinctions.shape[1]
    k = cfg.tracking_k
    keys = rng.as_lane_keys(keys, n)
    valid = active & (t_max >= 0.0) & (t_start < t_max)
    inv_max = 1.0 / max_extinction
    t_max_safe = jnp.maximum(t_max, 0.0)

    def cond(s):
        i, _, done, _ = s
        return (i < cfg.max_tracking_steps) & jnp.any(~done)

    if cfg.scalar_ray_geom:
        rp_c, xp_c = atm._ray_perigee(ray_pos, ray_dir)
    else:
        rp_c = xp_c = None

    draw = rng.fast_uniform if cfg.fast_loop_rng else (
        lambda ks, i, shape: rng.uniform(rng.fold(ks, i), shape)
    )

    def make_body(ctx):
        (keys, ray_pos, ray_dir, t_max, t_max_safe, extinctions, inv_max,
         rp, xp) = ctx

        def body(s):
            i, t, done, trans = s
            u = draw(keys, i, (k,))  # (k, n)
            steps = -jnp.log(jnp.maximum(u, 1e-12)) * inv_max
            ts = t[None, :] + jnp.cumsum(steps, axis=0)
            if cfg.scalar_ray_geom:
                x = xp[None, :] + jnp.minimum(ts, t_max_safe)
                rlen = jnp.sqrt(rp[None, :] * rp[None, :] + x * x)
                dens = vol.get_density(rlen - C.PLANET_R)  # (k, n, 3)
            else:
                pos = ray_pos[None] + jnp.minimum(ts, t_max_safe)[..., None] * ray_dir[None]
                dens = vol.get_density(vol.get_elevation(pos))  # (k, n, 3)
            total = jnp.einsum(
                "nlc,knc->knl", extinctions, dens, precision=HIGHEST
            )  # (k, n, L)
            inside = (ts < t_max) & (~done)[None, :]
            factors = jnp.where(
                inside[..., None], 1.0 - total * inv_max[None, :, None], 1.0
            )
            trans = trans * jnp.prod(factors, axis=0)
            t = jnp.where(done, t, ts[-1])
            done = done | (ts[-1] >= t_max) | (jnp.max(trans, axis=-1) < 1e-5)
            return i + 1, t, done, trans

        return body

    init = (jnp.int32(0), t_start, ~valid, jnp.ones((n, L)))
    _, _, _, trans = _run_narrowed(
        cond, make_body,
        (keys, ray_pos, ray_dir, t_max, t_max_safe, extinctions, inv_max,
         rp_c, xp_c),
        init, done_index=2, cfg=cfg,
    )
    return trans


# Cloud majorant-mip geometry: the two mip channels of atlas.clouds are
# dilated maxes (assets/textures.py MIP_*_DILATE_KM), so a tap at position p
# bounds the density within the corresponding validity radius. Tracking stays
# within the fine mip's validity of the last tap; certified-empty space is
# skipped at the fine stride near clouds and the coarse stride in clear sky.
# Three-level skip/track ladder over the cloud texture's three mip bounds
# (assets/textures.with_mips): ch 1 = TIGHT fine bound (8 km validity —
# Woodcock majorant + tracking budget; its small build dilation keeps the
# fake-cloudy margin sun chords crawl through to ~1 mip cell), ch 3 = WIDE
# fine bound (25 km validity — 20 km certified strides across the gaps of
# broken cloud fields, where the 156 km-cell coarse mip is never clear),
# ch 2 = coarse bound (100 km strides over genuinely clear oceans of sky).
_CLOUD_VALID = 8e3  # tight-mip validity: tracking/fine-skip certification
_CLOUD_VALID_WIDE = 25e3
_CLOUD_VALID_COARSE = 115e3
_CLOUD_SKIP_FINE = 6e3
_CLOUD_SKIP_WIDE = 20e3  # < 25 km wide-mip validity
_CLOUD_SKIP_COARSE = 100e3  # < 115 km coarse-mip validity
# stacked validity column for the fused 3-channel band skip (tight/wide/coarse)
_CVALID3 = jnp.array(
    [_CLOUD_VALID, _CLOUD_VALID_WIDE, _CLOUD_VALID_COARSE], jnp.float32
)[:, None]


def _track_cloud(
    keys, ray_pos, ray_dir, t_start, t_max, ext_w, max_extinction,
    clouds_tex, active, cfg: TraceConfig, mode: str,
):
    """Space-skipping cloud tracking (mode = 'delta' or 'ratio').

    Spatially-varying-majorant tracking with a two-level majorant ladder
    fused into the texture fetch: every tap of the 4-channel cloud texture
    returns the fine column-height sample AND dilated-max mips at two scales
    (fine: ~20 km cells valid within 25 km; coarse: ~156 km cells valid
    within 115 km). Per loop iteration, each lane is in one of three modes:

    - coarse-skip (last tap's coarse mip = 0): K probes spaced 100 km jump
      past certified-clear sky — limb chords through clear atmosphere cost
      ~chord/400 km iterations;
    - fine-skip (coarse > 0 but fine = 0): K probes spaced 20 km thread the
      gaps of broken cloud fields;
    - tracking (fine > 0): K speculative Woodcock steps against the *local*
      fine majorant, clamped to its validity radius.

    Mode transitions come for free from the stop tap's mip values. Unbiased:
    every jump is through a region its certifying tap bounds, Woodcock steps
    never leave their majorant's validity region, and majorant switches
    exploit exponential memorylessness. The reference tracks the whole chord
    against the global majorant (pathtracer.py:77-143) — thousands of steps
    for limb rays.
    """
    n = t_start.shape[0]
    k = cfg.tracking_k
    keys = rng.as_lane_keys(keys, n)
    is_delta = mode == "delta"
    valid = active & (t_max >= 0.0) & (t_start < t_max)
    t_max_safe = jnp.maximum(t_max, 0.0)
    arange_k = jnp.arange(k)[:, None]

    def cond(s):
        i, done = s[0], s[2]
        return (i < cfg.max_tracking_steps) & jnp.any(~done)

    if cfg.scalar_ray_geom:
        # hoisted ray quadratic (params.scalar_ray_geom): |ro(t)| from one
        # sqrt; no (k, n, 3) position arrays in the loop body
        b0_c = mu.dot(ray_pos, ray_dir)
        cr = jnp.cross(ray_pos, ray_dir)
        h2_c = jnp.sum(cr * cr, axis=-1)
    else:
        b0_c = h2_c = None

    draw = rng.fast_uniform if cfg.fast_loop_rng else (
        lambda ks, i, shape: rng.uniform(rng.fold(ks, i), shape)
    )

    def make_body(ctx):
        keys, ray_pos, ray_dir, t_max, t_max_safe, ext_w, b0, h2 = ctx

        def majorant(mip_val):
            """Per-lane local majorant from a fine-mip value (0 = clear)."""
            return jnp.where(
                mip_val > 0.0,
                ext_w * C.CLOUDS_DENSITY * jnp.maximum(mip_val, 0.4),
                0.0,
            )

        def body(s):
            i, t, done, t_fetch, sig_loc, stride, event, trans = s
            u = draw(keys, i, (3, k))  # (3, k, n)

            skipping = sig_loc <= 0.0
            budget_end = jnp.minimum(t_fetch + _CLOUD_VALID, t_max)

            # probe positions: skip-probes at the lane's stride (first at the
            # current position: its tap re-certifies the zone ahead), or
            # speculative Woodcock steps
            skip_ts = t[None, :] + arange_k.astype(jnp.float32) * stride[None, :]
            steps = -jnp.log(jnp.maximum(u[0], 1e-12)) / jnp.maximum(sig_loc, 1e-20)
            wood_ts = t[None, :] + jnp.cumsum(steps, axis=0)
            ts = jnp.where(skipping[None, :], skip_ts, wood_ts)
            crossed = jnp.where(
                skipping[None, :], ts >= t_max, ts >= budget_end[None, :]
            )
            ts_c = jnp.minimum(
                ts, jnp.where(skipping, t_max_safe, jnp.minimum(budget_end, t_max_safe))[None, :]
            )
            if cfg.scalar_ray_geom:
                bb = b0[None, :] + ts_c
                rlen = jnp.sqrt(h2[None, :] + bb * bb)
                sample = tx.sample_ray_texture(
                    clouds_tex, ray_pos, ray_dir, ts_c, rlen,
                    bilinear=cfg.bilinear_tracking,
                )  # (k, n, 4): column height, tight/coarse/wide mips
            else:
                pos = ray_pos[None] + ts_c[..., None] * ray_dir[None]
                sample = tx.sample_sphere_texture(
                    clouds_tex, pos, bilinear=cfg.bilinear_tracking
                )  # (k, n, 4): column height, tight mip, coarse mip, wide mip
                rlen = mu.length(pos)
            fine_ext = ext_w[None, :] * _cloud_shape_density(
                sample[..., 0], rlen
            )
            mips_k = sample[..., 1:4]  # (k, n, 3): tight, coarse, wide
            mip_f = mips_k[..., 0]
            mip_c = mips_k[..., 1]
            mip_w_ = mips_k[..., 2]

            # --- skip branch: jump to the first occupied probe at the lane's
            # skip level; each stride level tests its own certification bound
            lvl_coarse = stride > _CLOUD_SKIP_WIDE * 1.5
            lvl_wide = (~lvl_coarse) & (stride > _CLOUD_SKIP_FINE * 1.5)
            probe_occ = jnp.where(
                lvl_coarse[None, :],
                mip_c > 0.0,
                jnp.where(lvl_wide[None, :], mip_w_ > 0.0, mip_f > 0.0),
            )
            skip_stop = probe_occ | crossed
            skip_any = jnp.any(skip_stop, axis=0)
            skip_first = jnp.argmax(skip_stop, axis=0)
            pickf = (arange_k == skip_first[None, :]).astype(ts.dtype)
            skip_t = jnp.where(
                skip_any, jnp.sum(ts_c * pickf, axis=0), t + k * stride
            )
            # stacked 3-channel mip select (fusion-group diet): one reduce
            # for all three bound channels instead of three
            skip_mips = jnp.where(
                skip_any[:, None],
                jnp.sum(mips_k * pickf[..., None], axis=0),
                mips_k[-1],
            )  # (n, 3)

            # --- tracking branch: first real collision or budget crossing
            ratio = fine_ext / jnp.maximum(sig_loc[None, :], 1e-20)
            real_k = (u[1] < ratio) & (~crossed)
            stop_k = real_k | crossed
            any_stop = jnp.any(stop_k, axis=0)
            first = jnp.argmax(stop_k, axis=0)
            pick = (arange_k == first[None, :]).astype(ts.dtype)
            psel = lambda a: jnp.sum(a * pick, axis=0)
            if is_delta:
                wood_t = jnp.where(any_stop, psel(ts_c), ts_c[-1])
                wood_real = any_stop & (psel(real_k.astype(ts.dtype)) > 0.5)
                # refresh the majorant from the tap at the stopping/last position
                wood_mips = jnp.where(
                    any_stop[:, None],
                    jnp.sum(mips_k * pick[..., None], axis=0),
                    mips_k[-1],
                )
            else:
                # ratio mode: every in-budget probe contributes a factor; advance
                # past all of them (to the budget boundary if it was crossed)
                any_crossed = jnp.any(crossed, axis=0)
                first_cross = jnp.argmax(crossed, axis=0)
                pick_c = (arange_k == first_cross[None, :]).astype(ts.dtype)
                wood_t = jnp.where(
                    any_crossed, jnp.sum(ts_c * pick_c, axis=0), ts_c[-1]
                )
                wood_real = jnp.zeros(t.shape, bool)
                wood_mips = jnp.where(
                    any_crossed[:, None],
                    jnp.sum(mips_k * pick_c[..., None], axis=0),
                    mips_k[-1],
                )
                factors = jnp.where(crossed, 1.0, 1.0 - ratio)
                block = jnp.prod(factors, axis=0)

            step_lane = (~done) & (~skipping)
            skip_lane = (~done) & skipping

            t_new = jnp.where(skip_lane, skip_t, jnp.where(step_lane, wood_t, t))
            new_mips = jnp.where(skip_lane[:, None], skip_mips, wood_mips)
            new_mip_f = new_mips[..., 0]
            new_mip_c = new_mips[..., 1]
            new_mip_w = new_mips[..., 2]
            moved = skip_lane | step_lane
            sig_new = jnp.where(moved, majorant(new_mip_f), sig_loc)
            stride_new = jnp.where(
                moved,
                jnp.where(
                    new_mip_c <= 0.0,
                    _CLOUD_SKIP_COARSE,
                    jnp.where(
                        new_mip_w <= 0.0, _CLOUD_SKIP_WIDE, _CLOUD_SKIP_FINE
                    ),
                ),
                stride,
            )
            t_fetch_new = jnp.where(moved, t_new, t_fetch)

            if is_delta:
                hit = step_lane & wood_real
                scatters = psel(u[2]) < C.CLOUD_ALBEDO
                event = jnp.where(
                    hit, jnp.where(scatters, SCATTER_EVENT, ABSORB_EVENT), event
                )
                done = done | hit
            else:
                trans = jnp.where(step_lane, trans * block, trans)
                # transmittance Russian roulette: once the packet max drops
                # under 0.05, continue with p = trans/0.05 and reweight (exactly
                # unbiased). Deeply-occluded sun chords — the dominant NEE cost
                # at grazing sun, where the slab chord is hundreds of km —
                # terminate in ~1 extra iteration instead of grinding the
                # product down to a fixed cutoff. (u[2] is unused in ratio
                # mode, so probe row 0 supplies the RR draw.)
                t_rr = 0.05
                p_cont = jnp.clip(trans / t_rr, 0.0, 1.0)
                rr_active = step_lane & (p_cont < 1.0)
                killed = rr_active & (u[2, 0] >= p_cont)
                boosted = rr_active & ~killed
                trans = jnp.where(
                    killed, 0.0, trans / jnp.where(boosted, p_cont, 1.0)
                )
                done = done | killed | (trans < 1e-5)

            # --- analytic radial-band skip from the stop tap. The mips are 2D
            # (lat/lon) but the split shape is radial: a grazing chord through
            # "2D-cloudy" airspace whose radius stays outside the occupied band
            # would otherwise Woodcock-crawl it at ~350 m majorant steps (the
            # measured worst-lane tail: ~250 loop iterations). Each bound
            # channel certifies emptiness outside its band within its validity;
            # jump by the best of the three. Applies only where t_new sits AT
            # the certifying tap (skip lanes that found no occupied probe have
            # already advanced a stride past their last tap).
            at_tap = (~skip_lane) | skip_any
            jmask = (~done) & moved & at_tap
            if cfg.scalar_ray_geom:
                b_stop = b0 + t_new
                h2s = h2
                r_stop = jnp.sqrt(h2 + b_stop * b_stop)
            else:
                pos_stop = ray_pos + t_new[:, None] * ray_dir
                b_stop = jnp.sum(pos_stop * ray_dir, axis=-1)
                crs = jnp.cross(pos_stop, ray_dir)
                h2s = jnp.sum(crs * crs, axis=-1)  # stable perigee^2
                r_stop = mu.length(pos_stop)
            # Stacked 3-channel band-entry (fusion-group diet): one shared
            # ray quadratic, one sqrt per root family across all 3 bounds.
            # Classification carries a few meters of margin (beps): at
            # planet radius f32 resolves ~0.5 m, so a lane sitting ON a
            # boundary sphere can read as outside while the root collapses
            # to <=0 noise — without the margin that combination certified
            # a bogus full-validity jump THROUGH the band (caught by the
            # tracking-equivalence tests). Boundary-zone lanes count as
            # inside (entry 0 — never skip), and a "below" lane whose far
            # root is non-positive enters immediately.
            mips3 = jnp.stack([new_mip_f, new_mip_w, new_mip_c])  # (3, n)
            lo3, hi3 = _cloud_band_radii(mips3)
            big = jnp.float32(3e7)
            beps = 4.0
            above3 = r_stop[None] > hi3 + beps
            below3 = r_stop[None] < lo3 - beps
            dh = hi3 * hi3 - h2s[None]
            hi_near = jnp.where(
                dh < 0.0, -1.0, -b_stop[None] - jnp.sqrt(jnp.maximum(dh, 0.0))
            )
            dl = lo3 * lo3 - h2s[None]
            lo_far = jnp.where(
                dl < 0.0, -1.0, -b_stop[None] + jnp.sqrt(jnp.maximum(dl, 0.0))
            )
            t_ent3 = jnp.where(
                above3,
                jnp.where(hi_near > 0.0, hi_near, big),
                jnp.where(below3, jnp.maximum(lo_far, 0.0), 0.0),
            )
            jump = jnp.max(jnp.minimum(t_ent3, _CVALID3), axis=0)
            jump = jnp.where(jmask, jump, 0.0)
            t_new = t_new + jump
            jumped = jump > 0.0
            # a jumped lane lands uncertified: drop to skip mode so the next
            # iteration's probe 0 re-certifies from the landing point
            sig_new = jnp.where(jumped, 0.0, sig_new)
            t_fetch_new = jnp.where(jumped, t_new, t_fetch_new)

            done = done | (t_new >= t_max)
            return i + 1, t_new, done, t_fetch_new, sig_new, stride_new, event, trans

        return body

    init = (
        jnp.int32(0),
        t_start,
        ~valid,
        t_start,
        jnp.zeros((n,)),
        jnp.full((n,), _CLOUD_SKIP_FINE),
        jnp.full((n,), NULL_EVENT, dtype=jnp.int32),
        jnp.ones((n,)),
    )
    _, t, _, _, _, _, event, trans = _run_narrowed(
        cond, make_body,
        (keys, ray_pos, ray_dir, t_max, t_max_safe, ext_w, b0_c, h2_c),
        init, done_index=2, cfg=cfg,
    )
    if is_delta:
        return event, t
    return trans


def intersect_cloud_limits(ray_pos, ray_dir, land_isection):
    """Parametric span of the cloud slab along the ray
    (reference pathtracer.py:145-169)."""
    r = mu.length(ray_pos)
    lo_n, lo_f = mu.rsi(ray_pos, ray_dir, C.CLOUDS_LOWER_LIMIT)
    up_n, up_f = mu.rsi(ray_pos, ray_dir, C.CLOUDS_UPPER_LIMIT)

    above = r >= C.CLOUDS_UPPER_LIMIT
    inside = (~above) & (r >= C.CLOUDS_LOWER_LIMIT)

    t_start_above = jnp.maximum(0.0, up_n)
    t_max_above = jnp.where(lo_f >= 0.0, lo_n, up_f)
    t_max_above = jnp.where(up_f < 0.0, -1.0, t_max_above)

    t_start_inside = jnp.zeros_like(r)
    t_max_inside = jnp.where(lo_f >= 0.0, lo_n, up_f)

    t_start_below = lo_f
    t_max_below = jnp.where(land_isection > 0.0, -1.0, up_f)

    t_start = jnp.where(above, t_start_above, jnp.where(inside, t_start_inside, t_start_below))
    t_max = jnp.where(above, t_max_above, jnp.where(inside, t_max_inside, t_max_below))
    return t_start, t_max


def _rmo_span(ray_pos, ray_dir, land_isection):
    """Atmosphere span clipped by the land hit (reference pathtracer.py:180-184)."""
    a_near, a_far = mu.rsi(ray_pos, ray_dir, C.ATMOS_UPPER_LIMIT)
    t_start = jnp.maximum(0.0, a_near)
    t_max = jnp.where(land_isection >= 0.0, land_isection, a_far)
    t_max = jnp.where(a_far < 0.0, -1.0, t_max)
    return t_start, t_max


def sample_interaction(
    keys, ray_pos, ray_dir, land_isection, ext_rmo, ext_w, max_ext_rmo,
    max_ext_cloud, atlas, active, cfg: TraceConfig,
):
    """Two-pass free-flight sampling by superposition: the cloud slab, then
    the RMO gases capped at the cloud event; the nearer event wins
    (reference pathtracer.py:172-207 runs RMO first — the combined first-event
    distribution is order-independent; cloud-first lets the RMO pass stop
    exactly at the joint event).

    ext_rmo: (n, L, 3) per-wavelength extinction coefficients; ext_w: (n,)
    cloud extinction. Returns (event, t, interaction_id, c_event, c_t) —
    the cloud pass's own event rides along so the lazy-march scheduler can
    re-merge after demoting RMO events past the land hit (the reference
    caps only the RMO span by the land hit; its cloud span for above/inside
    rays ignores land entirely — reference pathtracer.py:145-169 — so a
    cloud event behind a terrain peak scatters there, and demoting it into
    a surface hit measured -5.6% whole-image, docs/PARITY.md). Hero-packet
    MIS weights are computed afterwards (spectral_flight_weights).
    """
    n = ray_pos.shape[0]
    L = ext_rmo.shape[1]
    keys = rng.as_lane_keys(keys, n)
    k_rmo = rng.fold(keys, _SUB_RMO)
    k_cloud = rng.fold(keys, _SUB_CLOUD)
    t_start, t_max = _rmo_span(ray_pos, ray_dir, land_isection)

    if cfg.naive_tracking:
        assert L == 1, "naive_tracking supports single-wavelength tracing only"
        ext4 = jnp.concatenate([ext_rmo[:, 0, :], jnp.zeros((n, 1))], axis=-1)
        rmo_event, rmo_t, rmo_id = tn.delta_track_naive(
            k_rmo, ray_pos, ray_dir, t_start, t_max, ext4, max_ext_rmo,
            atlas.clouds, "rmo", active, cfg,
        )
        if not cfg.enable_clouds:
            return (rmo_event, rmo_t, rmo_id,
                    jnp.zeros((n,), jnp.int32), jnp.zeros((n,)))
        c_start, c_max = intersect_cloud_limits(ray_pos, ray_dir, land_isection)
        cloud_active = active & ((rmo_event == NULL_EVENT) | (rmo_t > c_start))
        cloud_ext = jnp.zeros((n, 4)).at[:, 3].set(ext_w)
        c_event, c_t, _ = tn.delta_track_naive(
            k_cloud, ray_pos, ray_dir, c_start, c_max, cloud_ext,
            max_ext_cloud, atlas.clouds, "cloud", cloud_active, cfg,
        )
        take = cloud_active & (c_event > NULL_EVENT) & (
            (c_t < rmo_t) | (rmo_event == NULL_EVENT)
        )
        event = jnp.where(take, c_event, rmo_event)
        t = jnp.where(take, c_t, rmo_t)
        iid = jnp.where(take, C.CLOUD_ID, rmo_id)
        return event, t, iid, jnp.where(cloud_active, c_event, 0), c_t

    if cfg.enable_clouds:
        c_start, c_max = intersect_cloud_limits(ray_pos, ray_dir, land_isection)
        if cfg.naive_cloud_tracking:
            cloud_ext4 = jnp.zeros((n, 4)).at[:, 3].set(ext_w)
            c_event, c_t, _ = tn.delta_track_naive(
                k_cloud, ray_pos, ray_dir, c_start, c_max, cloud_ext4,
                max_ext_cloud, atlas.clouds, "cloud", active, cfg,
            )
        else:
            c_event, c_t = _track_cloud(
                k_cloud, ray_pos, ray_dir, c_start, c_max, ext_w,
                max_ext_cloud, atlas.clouds, active, cfg, mode="delta",
            )
        # RMO tracking only needs to reach the cloud event (if any)
        rmo_cap = jnp.where(c_event > NULL_EVENT, jnp.minimum(t_max, c_t), t_max)
    else:
        rmo_cap = t_max

    if cfg.analytic_flight:
        rmo_event, rmo_t, rmo_id = _sample_rmo_flight_analytic(
            k_rmo, ray_pos, ray_dir, t_start, rmo_cap, ext_rmo, active, cfg
        )
    else:
        rmo_event, rmo_t, rmo_id = _delta_track_rmo(
            k_rmo, ray_pos, ray_dir, t_start, rmo_cap, ext_rmo, max_ext_rmo,
            active, cfg,
        )
    if not cfg.enable_clouds:
        return (rmo_event, rmo_t, rmo_id,
                jnp.zeros((n,), jnp.int32), jnp.zeros((n,)))

    take_cloud = (c_event > NULL_EVENT) & (rmo_event == NULL_EVENT)
    event = jnp.where(take_cloud, c_event, rmo_event)
    t = jnp.where(take_cloud, c_t, rmo_t)
    iid = jnp.where(take_cloud, C.CLOUD_ID, rmo_id)
    return event, t, iid, c_event, c_t


def sample_transmittance(
    keys, ray_pos, ray_dir, land_isection, ext_rmo, ext_w, max_ext_rmo,
    max_ext_cloud, atlas, active, cfg: TraceConfig,
):
    """Transmittance toward the sun: exact closed-form RMO transmittance from
    the density-integral table times cloud ratio-tracking (replacing the
    reference's two ratio-tracking passes, pathtracer.py:211-232 — the RMO
    factor is zero-variance here). ext_rmo (n, L, 3); returns per-wavelength
    transmittance (n, L)."""
    n = ray_pos.shape[0]
    L = ext_rmo.shape[1]
    keys = rng.as_lane_keys(keys, n)
    k_rmo = rng.fold(keys, _SUB_RMO)
    k_cloud = rng.fold(keys, _SUB_CLOUD)
    t_start, t_max = _rmo_span(ray_pos, ray_dir, land_isection)
    if cfg.naive_tracking:
        assert L == 1, "naive_tracking supports single-wavelength tracing only"
        ext4 = jnp.concatenate([ext_rmo[:, 0, :], jnp.zeros((n, 1))], axis=-1)
        trans = tn.ratio_track_naive(
            k_rmo, ray_pos, ray_dir, t_start, t_max, ext4, max_ext_rmo,
            atlas.clouds, "rmo", active, cfg,
        )[:, None]
    elif cfg.analytic_transmittance:
        trans = atm.rmo_transmittance_to_space(ext_rmo, ray_pos, ray_dir)
    else:
        trans = _ratio_track_rmo(
            k_rmo, ray_pos, ray_dir, t_start, t_max, ext_rmo,
            max_ext_rmo, active, cfg,
        )
    if not cfg.enable_clouds:
        return trans
    c_start, c_max = intersect_cloud_limits(ray_pos, ray_dir, land_isection)
    if cfg.naive_tracking or cfg.naive_cloud_tracking:
        cloud_ext = jnp.zeros((n, 4)).at[:, 3].set(ext_w)
        cloud_trans = tn.ratio_track_naive(
            k_cloud, ray_pos, ray_dir, c_start, c_max, cloud_ext,
            max_ext_cloud, atlas.clouds, "cloud", active, cfg,
        )
    else:
        cloud_trans = _track_cloud(
            k_cloud, ray_pos, ray_dir, c_start, c_max, ext_w,
            max_ext_cloud, atlas.clouds, active, cfg, mode="ratio",
        )
    return trans * cloud_trans[:, None]


def speckle(p, density):
    """Procedural point-light speckle field for nightlight shaping
    (reference pathtracer.py:272-282 — present but unused there; rebuilt for
    capability parity and usable as an optional emissive modulator).

    For each of the 3x3 grid cells around ``p`` ((..., 2) texture-space
    points), a jittered point is placed by hash22 and an exponentially
    distributed amplitude drawn by hash12, scaled by ``density``, then
    accumulated with an exp distance falloff. (The reference also computes a
    Gaussian-mixture pdf per point but never uses it — dead even within the
    dead function — so it is not reproduced.)
    """
    base = jnp.floor(p)
    m = jnp.zeros(p.shape[:-1])
    amp_scale = 1.5 * jnp.power(1.5 * jnp.clip(density, 0.0, 0.67), 1.5)
    falloff = 6.0 / jnp.clip(density, 0.67, 1.0)
    for y in (-1.0, 0.0, 1.0):
        for x in (-1.0, 0.0, 1.0):
            cell = base + jnp.asarray([x, y])
            q = cell + mu.hash22(cell)
            a = -jnp.log(1e-4 + (1.0 - 2e-4) * mu.hash12(q)) * amp_scale
            dist = mu.length(p - q)
            m = m + a * jnp.exp(-falloff * dist)
    return m


def get_land_material(atlas, pos, bilinear=True):
    """Albedo grading: darken/desaturate greenery, warm the deserts,
    desaturate the ocean, mix by the land-ocean mask
    (reference pathtracer.py:284-313). One packed 8-channel texture fetch
    replaces the reference's four separate samples."""
    mat = tx.sample_sphere_texture(atlas.material, pos, bilinear=bilinear)
    albedo_texture_srgb = mat[..., 0:3]
    ocean = mat[..., 3]

    land_albedo = mu.mix(sp.lum3(albedo_texture_srgb), albedo_texture_srgb, 6.5)
    land_greenery = jnp.power(
        land_albedo[..., 1] / jnp.maximum(sp.lum(land_albedo), 1e-8), 2.0
    )
    land_greenery = mu.smoothstep(1.5, 1.9, land_greenery)
    land_albedo = albedo_texture_srgb / (land_greenery[..., None] * 0.7 + 1.0)
    land_albedo = mu.mix(
        sp.lum3(land_albedo), land_albedo, (1.4 - land_greenery * 0.45)[..., None]
    )
    warm = jnp.array([255.0, 128.0, 64.0]) / 255.0
    land_albedo = mu.mix(
        land_albedo, land_albedo * warm, (0.2 * (1.0 - land_greenery))[..., None]
    )

    ocean_albedo = mu.mix(sp.lum3(albedo_texture_srgb), albedo_texture_srgb, 0.75) * 0.9
    albedo_srgb = mu.mix(land_albedo, ocean_albedo, ocean[..., None])

    bathymetry = mat[..., 4]
    emissive = mat[..., 5]
    return albedo_srgb, ocean, bathymetry, emissive


# ---------------------------------------------------------------------------
# The wavefront bounce loop (reference pathtracer.py:316-469)
# ---------------------------------------------------------------------------

from typing import NamedTuple  # noqa: E402


class TraceState(NamedTuple):
    """Per-lane wavefront state carried across bounce stages.

    Two-level scheduling: the renderer runs the bounce loop in *stages*
    (``run_bounces``) and compacts alive lanes between them, so tiles whose
    lanes have all terminated exit their while-loops immediately instead of
    pacing the worst lane for 25 bounces (SURVEY.md §7 "hard parts" #1).
    """

    pos: jnp.ndarray          # (N, 3)
    direction: jnp.ndarray    # (N, 3)
    wavelength: jnp.ndarray   # (N, L)
    lambda_pdf: jnp.ndarray   # (N, L)
    throughput: jnp.ndarray   # (N, L)
    radiance: jnp.ndarray     # (N, L)
    w_mis: jnp.ndarray        # (N, L)
    alive: jnp.ndarray        # (N,) bool
    primary_miss: jnp.ndarray # (N,) bool
    # per-lane RNG key (ops/rng.py): derived from (spp key, global pixel
    # id) at ray generation and permuted with the lane by the stage
    # compactor, so a lane's random stream is independent of every
    # execution-layout choice (tiling, compaction, device mesh).
    rng: jnp.ndarray          # (N, 2) uint32
    # workload class of the lane's NEXT bounce, for homogeneous SIMD
    # scheduling (renderer stage compaction bins by it): 0 = cloud
    # scatter, 1 = gas scatter, 2 = surface bounce. Tracking loops run at
    # worst-lane pace, so mixing a 200-iteration near-terrain lane into a
    # tile of in-cloud lanes stalls all 32K of them; binning makes each
    # stage tile's iteration profile uniform.
    work_class: jnp.ndarray   # (N,) int32


def init_state(ray_pos, ray_dir, wavelength, lambda_pdf=None,
               rng_keys=None) -> TraceState:
    """``rng_keys``: (N, 2) per-lane keys or one (2,) key (expanded over
    lane index — fine for tests/tools; the renderer passes pixel-derived
    keys so streams survive any tiling)."""
    n, L = wavelength.shape
    if lambda_pdf is None:
        lambda_pdf = jnp.ones((n, L))
    if rng_keys is None:
        rng_keys = jax.random.PRNGKey(0)
    return TraceState(
        pos=ray_pos,
        direction=ray_dir,
        wavelength=wavelength,
        lambda_pdf=lambda_pdf,
        throughput=jnp.ones((n, L)),
        radiance=jnp.zeros((n, L)),
        w_mis=jnp.ones((n, L)),
        alive=jnp.ones((n,), dtype=bool),
        primary_miss=jnp.zeros((n,), dtype=bool),
        work_class=jnp.zeros((n,), dtype=jnp.int32),
        rng=rng.as_lane_keys(rng_keys, n),
    )


def run_bounces(
    st: TraceState, scene: SceneParams, atlas, luts, cfg: TraceConfig,
    bounce_start, bounce_stop, unroll: int | None = None,
) -> TraceState:
    """Advance the wavefront from ``bounce_start`` until ``bounce_stop`` (or
    every lane terminates). The loop body reproduces the reference's scatter
    loop (pathtracer.py:349-453); see trace_paths for the estimator notes.

    ``bounce_start``/``bounce_stop`` may be traced scalars: the renderer's
    stage scheduler compiles ONE stage function and sweeps the bounce window
    dynamically (the loop is a while_loop, so trip counts are dynamic
    anyway).

    ``unroll``: with a static stage width (the scheduler's windows are 1-2
    bounces), pass it here to replace the outer while_loop with ``unroll``
    inline body applications — XLA's while op costs real per-iteration
    overhead (carry shuffling + condition evaluation). Steps beyond
    ``bounce_stop`` are discarded by a scalar select, so the result is
    bit-identical to the while version."""
    wavelength = st.wavelength
    n, L = wavelength.shape
    lambda_pdf = st.lambda_pdf
    rng_keys = st.rng  # (n, 2); constant across bounces, closed over
    scale = scene.land_height_scale

    # Per-wavelength constants (reference pathtracer.py:332-343); pure
    # math on (n, L), recomputed per stage rather than carried.
    sun_power = sp.plancks(C.SUN_TEMPERATURE, wavelength)  # (n, L)
    nightlights_power = (
        sp.plancks(C.NIGHTLIGHT_TEMPERATURE, wavelength) * C.NIGHTLIGHT_SCALE
    )
    sun_irradiance = sun_power * mu.cone_angle_to_solid_angle(
        scene.sun_angular_radius
    )

    ext_rmo = jnp.stack(
        [
            vol.spectra_extinction_rayleigh(wavelength),
            vol.spectra_extinction_mie(wavelength),
            vol.spectra_extinction_ozone(wavelength, luts.o3_crossec),
        ],
        axis=-1,
    )  # (n, L, 3)
    # majorant over the whole packet: hero-driven free flights must majorize
    # every member's extinction
    max_ext_rmo = jnp.max(jnp.sum(ext_rmo * _MAX_DENS_RMO, axis=-1), axis=-1)  # (n,)

    light_direction = jnp.broadcast_to(scene.light_direction, (n, 3))

    _march = (
        tn.intersect_land_naive
        if (cfg.naive_tracking or cfg.naive_march)
        else intersect_land
    )

    def cond(state):
        bounce = state[0]
        alive = state[5]
        return (bounce < bounce_stop) & jnp.any(alive)

    def body(state):
        (bounce, pos, direction, throughput, radiance, alive,
         primary_miss, w_mis, work_class) = state

        # cloud extinction drops after bounce 9 (reference pathtracer.py:351-352)
        ext_w_scalar = jnp.where(
            bounce > C.MULTISCATTER_BOUNCE, C.MULTISCATTER_CLOUD_EXTINCT, C.CLOUDS_EXTINCT
        )
        ext_w = jnp.full((n,), 1.0) * ext_w_scalar
        max_ext_cloud = ext_w * C.CLOUDS_DENSITY

        # per-lane bounce keys (ops/rng.py): lane key -> bounce -> site
        kb = rng.fold(rng_keys, bounce)

        # bounce-dependent march floor (params.march_floor_frac_secondary):
        # secondary grazing rays carry the floor-tunneling bias, bounce-0
        # marching carries most of the cost
        if (cfg.march_floor_frac_secondary is not None
                and not (cfg.naive_tracking or cfg.naive_march)):
            march_kw = dict(floor_frac=jnp.where(
                bounce > 0,
                cfg.march_floor_frac_secondary, cfg.march_floor_frac,
            ))
        else:
            march_kw = {}

        # 1. land intersection, 2. free-flight sampling capped at the land
        # hit (reference pathtracer.py:359-368).
        if cfg.naive_tracking or not cfg.lazy_march:
            # march-first (reference order). A track-first reorder with the
            # march capped at the sampled event was slower before the GPU
            # port (not re-measured since): it
            # trades march iterations for *more* tracking iterations on
            # exactly the grazing near-terrain lanes that set the pace.
            earth = _march(atlas.topography, pos, direction, scale, alive,
                           cfg, **march_kw)
            event, t_int, iid, _, _ = sample_interaction(
                rng.fold(kb, _SITE_FLIGHT), pos, direction, earth, ext_rmo,
                ext_w, max_ext_rmo, max_ext_cloud, atlas, alive, cfg,
            )
        else:
            # March-on-demand: ONE topo tap at the ray origin certifies a
            # terrain-free ball (regional dilated-max mips bound terrain
            # radius within their validity radii; any ray from a point at
            # radius r travels min(valid, r - bound_radius) before it can
            # touch terrain). Tracking runs first against the base-sphere
            # cap (terrain lies above planet_r, so the true land hit — if
            # any — precedes the base-sphere hit; events sampled past the
            # land hit are demoted below, which leaves the distribution of
            # events *before* the hit untouched: free-flight sampling is
            # sequential). Lanes whose volume event lands inside the free
            # ball — the common case for in-cloud multi-scatter over ocean
            # or lowland — never march at all.
            tap = tx.sample_sphere_texture(
                atlas.topography, pos, bilinear=cfg.bilinear_tracking
            )
            r_len = mu.length(pos)
            d_free = jnp.maximum(
                jnp.maximum(
                    jnp.minimum(
                        _MIP_VALID_FINE,
                        r_len - (C.PLANET_R + scale * tap[..., 1]),
                    ),
                    jnp.minimum(
                        _MIP_VALID_COARSE,
                        r_len - (C.PLANET_R + scale * tap[..., 2]),
                    ),
                ),
                # channel 3 = tight 8 km bound: its small dilation gives the
                # least-inflated terrain radius for low bounces in valleys
                jnp.minimum(
                    _CLOUD_VALID,
                    r_len - (C.PLANET_R + scale * tap[..., 3]),
                ),
            )
            base_near, _ = mu.rsi(pos, direction, C.PLANET_R)
            cap_proxy = jnp.where(base_near > 0.0, base_near, -1.0)
            # Below-slab lanes (surface bounces under the cloud deck) march
            # up front: they would march anyway (d_free ~ 0 at terrain),
            # and the reference's below-ray cloud span is gated on the TRUE
            # land hit (pathtracer.py:168: any land hit kills the span), so
            # the proxy cap would mis-gate it.
            below = r_len < C.CLOUDS_LOWER_LIMIT
            pre = alive & below

            earth_pre = jax.lax.cond(
                jnp.any(pre),
                lambda _: _march(
                    atlas.topography, pos, direction, scale, pre, cfg,
                    **march_kw
                ),
                lambda _: jnp.full((n,), -1.0),
                None,
            )
            land_proxy = jnp.where(below, earth_pre, cap_proxy)
            event, t_int, iid, c_event, c_t = sample_interaction(
                rng.fold(kb, _SITE_FLIGHT), pos, direction, land_proxy,
                ext_rmo, ext_w, max_ext_rmo, max_ext_cloud, atlas, alive,
                cfg,
            )
            # cloud events never need the land hit: the reference's
            # above/inside cloud spans ignore land entirely (reference
            # pathtracer.py:145-166), so a cloud event stands no matter
            # where the terrain is; only RMO events are capped by it.
            need_march = alive & ~below & (
                (event == NULL_EVENT)
                | ((iid != C.CLOUD_ID) & (t_int > jnp.maximum(d_free, 0.0)))
            )
            t_cap = jnp.where(event > NULL_EVENT, t_int, 1e30)

            def do_march(_):
                if cfg.naive_march:  # the naive march has no t_cap arg
                    return _march(
                        atlas.topography, pos, direction, scale, need_march,
                        cfg,
                    )
                return _march(
                    atlas.topography, pos, direction, scale, need_march,
                    cfg, t_cap=t_cap, **march_kw
                )

            earth_post = jax.lax.cond(
                jnp.any(need_march), do_march,
                lambda _: jnp.full((n,), -1.0), None,
            )
            earth = jnp.where(below, earth_pre, earth_post)
            # Demote RMO events sampled beyond the (now-known) land hit —
            # the reference caps its RMO span at the hit (pathtracer.py:
            # 180-184) so those events do not exist there. If the cloud
            # pass had its own event, it takes over (the reference's
            # "nearer event wins" merge would have picked it since no RMO
            # event precedes it there); else the lane is a surface hit.
            demote = (
                (event > NULL_EVENT) & (iid != C.CLOUD_ID)
                & (earth >= 0.0) & (earth <= t_int)
            )
            resurrect = demote & (c_event > NULL_EVENT)
            event = jnp.where(
                demote, jnp.where(resurrect, c_event, NULL_EVENT), event
            )
            t_int = jnp.where(resurrect, c_t, t_int)
            iid = jnp.where(resurrect, C.CLOUD_ID, iid)

        # hero-packet MIS weight of this bounce's flight outcome
        if L > 1:
            rmo_t0, rmo_t1 = _rmo_span(pos, direction, earth)
            t_w = jnp.where(
                event > NULL_EVENT,
                t_int,
                jnp.where(earth > 0.0, earth, rmo_t1),
            )
            t_w = jnp.clip(t_w, rmo_t0, jnp.maximum(rmo_t1, rmo_t0))
            rmo_collision = (event > NULL_EVENT) & (iid != C.CLOUD_ID)
            w_mult = spectral_flight_weights(
                pos, direction, rmo_t0, t_w, ext_rmo, iid, rmo_collision, alive
            )
        else:
            w_mult = jnp.ones((n, 1))
        w_mis = w_mis * w_mult
        throughput = throughput * w_mult  # identical physical/pdf ratio terms
        # isotropic multi-scatter fallback (reference pathtracer.py:369-370)
        iid = jnp.where(
            (bounce > C.MULTISCATTER_BOUNCE) & (iid == C.CLOUD_ID),
            C.ISOTROPIC_CLOUD_ID,
            iid,
        )
        # spectral MIS balance denominator for this bounce's contributions
        denom = jnp.maximum(jnp.sum(lambda_pdf * w_mis, axis=-1), 1e-12)[:, None]

        # 3. NEE sun direction for every lane (reference pathtracer.py:373)
        u_c = rng.uniform(rng.fold(kb, _SITE_CONE), (2,))  # (2, n)
        light_dir = smp.sample_cone_oriented(
            u_c[0], u_c[1], scene.sun_cos_angle, light_direction
        )

        scatter = alive & (event == SCATTER_EVENT)
        surface = alive & (event == NULL_EVENT) & (earth > 0.0)
        miss = alive & (event == NULL_EVENT) & ~(earth > 0.0)

        # --- volume scattering lanes (reference pathtracer.py:376-401) ---
        t_safe = jnp.where(scatter, t_int, 0.0)
        int_pos = pos + t_safe[:, None] * direction
        _, planet_far = mu.rsi(int_pos, light_dir, C.PLANET_R)
        vol_occluded = planet_far > 0.0
        vol_nee = scatter & ~vol_occluded

        # --- surface lanes (reference pathtracer.py:404-439) ---
        # All surface work (material gathers, normals, shadow march, BRDFs)
        # is gated on any lane actually hitting land this bounce.
        u_h = rng.uniform(rng.fold(kb, _SITE_HEMI), (2,))  # (2, n)

        def surface_work(_):
            earth_safe = jnp.where(surface, earth, 0.0)
            land_pos = pos + earth_safe[:, None] * direction
            normal = land_normal(
                atlas.topography, land_pos, scale, cfg.bilinear_materials
            )
            albedo_srgb, ocean, bathymetry, emissive = get_land_material(
                atlas, land_pos, cfg.bilinear_materials
            )
            albedo = sp.srgb_to_spectrum(
                luts.srgb2spec, albedo_srgb[:, None, :], wavelength
            )  # (n, L)
            offset_pos = land_pos * (1.0 + 0.0001 * scale / 12000.0)
            if cfg.nee_off:
                shadow_hit = jnp.full((n,), 1.0)  # "occluded": no sun NEE
            elif cfg.naive_tracking or cfg.naive_march or cfg.naive_shadow:
                shadow_hit = tn.intersect_land_naive(
                    atlas.topography, offset_pos, light_dir, scale, surface,
                    cfg,
                )
            else:
                # occlusion only: any-hit march (see intersect_land)
                shadow_hit = intersect_land(
                    atlas.topography, offset_pos, light_dir, scale, surface,
                    cfg, any_hit=True,
                )
            sur_vis = shadow_hit < 0.0
            # the BRDF is linear in the spectral albedo: evaluate geometry
            # once, combine per wavelength (reference pathtracer.py:431-439)
            d_diff, d_spec, d_ndl = srf.earth_brdf_parts(
                ocean, bathymetry, -direction, normal, light_dir
            )
            d_term = (albedo * d_diff[:, None] + d_spec[:, None]) * d_ndl[:, None]
            hemi_dir = smp.sample_hemisphere_cosine_weighted(u_h[0], u_h[1], normal)
            b_diff, b_spec, _ = srf.earth_brdf_parts(
                ocean, bathymetry, -direction, normal, hemi_dir
            )
            b_brdf = albedo * b_diff[:, None] + b_spec[:, None]  # (n, L)
            return offset_pos, sur_vis, emissive, d_term, hemi_dir, b_brdf

        def surface_skip(_):
            return (
                pos,
                jnp.zeros((n,), bool),
                jnp.zeros((n,)),
                jnp.zeros((n, L)),
                jnp.broadcast_to(jnp.array([0.0, 1.0, 0.0]), (n, 3)),
                jnp.zeros((n, L)),
            )

        offset_pos, sur_vis, emissive, d_term, hemi_dir, b_brdf = jax.lax.cond(
            jnp.any(surface), surface_work, surface_skip, None
        )
        sur_nee = surface & sur_vis

        # merged NEE transmittance (reference pathtracer.py:387,424)
        nee_origin = jnp.where(surface[:, None], offset_pos, int_pos)
        nee_active = vol_nee | sur_nee
        # deep-bounce NEE Russian roulette (cfg.nee_rr_*): keep the shadow
        # track with prob p, reweight by 1/p — unbiased decimation of the
        # dominant cloud ratio-tracking on the multi-scatter tail
        if cfg.nee_rr_prob < 1.0:
            u_nee = rng.uniform(rng.fold(kb, _SITE_NEE_RR))
            rr_nee = bounce > cfg.nee_rr_start
            nee_keep = (~rr_nee) | (u_nee < cfg.nee_rr_prob)
            nee_active = nee_active & nee_keep
            nee_w = jnp.where(rr_nee, 1.0 / cfg.nee_rr_prob, 1.0)
        else:
            nee_w = jnp.ones(())
        if cfg.nee_off:
            # DIAGNOSTIC (cfg.nee_off, biased-dark): no sun-cone NEE at all —
            # the static flag compiles the transmittance tracking out, so a
            # bench diff against the default isolates the NEE share of the
            # frame.
            trans = jnp.zeros((n, L))
            vol_nee = jnp.zeros((n,), bool)
            sur_nee = jnp.zeros((n,), bool)
        else:
            trans = sample_transmittance(
                rng.fold(kb, _SITE_TRANS), nee_origin, light_dir,
                jnp.full((n,), -1.0), ext_rmo, ext_w, max_ext_rmo,
                max_ext_cloud, atlas, nee_active, cfg,
            )  # (n, L)
        if cfg.nee_rr_prob < 1.0:
            trans = trans * jnp.where(nee_active, nee_w, 0.0)[:, None]
            vol_nee = vol_nee & nee_keep
            sur_nee = sur_nee & nee_keep

        reduce_peak = bounce > 0
        phase_d = vol.evaluate_phase(direction, light_dir, iid, reduce_peak)
        radiance = radiance + jnp.where(
            vol_nee[:, None],
            throughput * trans * sun_irradiance * phase_d[:, None] / denom,
            0.0,
        )

        # emissive nightlights (reference pathtracer.py:417)
        radiance = radiance + jnp.where(
            surface[:, None],
            throughput * emissive[:, None] * nightlights_power / denom,
            0.0,
        )
        radiance = radiance + jnp.where(
            sur_nee[:, None],
            throughput * trans * sun_irradiance * d_term / denom,
            0.0,
        )

        # --- continue the path (reference pathtracer.py:397-401, 434-439) ---
        u_ph = rng.uniform(rng.fold(kb, _SITE_PHASE), (3,))  # (3, n)
        phase_dir, phase_w = vol.sample_phase_dirs(
            u_ph[0], u_ph[1], u_ph[2], direction, iid, reduce_peak
        )

        new_dir = jnp.where(
            scatter[:, None], phase_dir, jnp.where(surface[:, None], hemi_dir, direction)
        )
        new_pos = jnp.where(
            scatter[:, None], int_pos, jnp.where(surface[:, None], offset_pos, pos)
        )
        new_thr = jnp.where(
            scatter[:, None],
            throughput * phase_w[:, None],
            jnp.where(surface[:, None], throughput * b_brdf * math.pi, throughput),
        )

        primary_miss = primary_miss | (miss & (bounce == 0))
        alive = scatter | surface

        # Russian roulette, decided by the hero throughput
        # (reference pathtracer.py:448-453)
        rr_on = alive & (bounce > cfg.rr_start)
        p_kill = jnp.maximum(0.05, 1.0 - new_thr[:, 0])
        u_rr = rng.uniform(rng.fold(kb, _SITE_RR))
        killed = rr_on & (u_rr < p_kill)
        new_thr = jnp.where(
            (rr_on & ~killed)[:, None], new_thr / (1.0 - p_kill[:, None]), new_thr
        )
        alive = alive & ~killed

        # deep-cloud path roulette (cfg.cloud_rr_*): unbiased decimation of
        # the bounce 8-24 multi-scatter tail; killed lanes are compacted out
        # between stages so this shrinks the tail tile count directly
        if cfg.cloud_rr_keep < 1.0:
            in_cloud_now = (iid == C.CLOUD_ID) | (iid == C.ISOTROPIC_CLOUD_ID)
            crr = alive & scatter & in_cloud_now & (bounce >= cfg.cloud_rr_start)
            u_crr = rng.uniform(rng.fold(kb, _SITE_CLOUD_RR))
            ckilled = crr & (u_crr >= cfg.cloud_rr_keep)
            new_thr = jnp.where(
                (crr & ~ckilled)[:, None], new_thr / cfg.cloud_rr_keep, new_thr
            )
            alive = alive & ~ckilled

        # workload class of the lane's next bounce (stage-compaction bin).
        # work_bins=5 additionally splits the two scatter classes by a
        # next-bounce cost proxy — tracking loops run at worst-lane pace,
        # so the finer the tiles' iteration-profile uniformity, the less
        # a tile waits on its slowest lane: cloud lanes by slab-core vs
        # slab-edge position (core = dense shape function = many Woodcock
        # steps), gas lanes by low vs high altitude (low = denser gas and
        # march-adjacent terrain).
        in_cloud = (iid == C.CLOUD_ID) | (iid == C.ISOTROPIC_CLOUD_ID)
        if cfg.work_bins >= 5:
            r_next = mu.length(new_pos)
            slab_mid = 0.5 * (C.CLOUDS_LOWER_LIMIT + C.CLOUDS_UPPER_LIMIT)
            slab_half = 0.5 * (C.CLOUDS_UPPER_LIMIT - C.CLOUDS_LOWER_LIMIT)
            cloud_core = jnp.abs(r_next - slab_mid) < 0.5 * slab_half
            gas_low = r_next < C.PLANET_R + 30e3
            cls = jnp.where(
                scatter & in_cloud,
                jnp.where(cloud_core, 0, 1),
                jnp.where(scatter, jnp.where(gas_low, 2, 3), 4),
            )
        else:
            cls = jnp.where(scatter & in_cloud, 0, jnp.where(scatter, 1, 2))
        work_class = jnp.where(alive, cls, work_class)

        return (
            bounce + 1, new_pos, new_dir, new_thr, radiance, alive,
            primary_miss, w_mis, work_class,
        )

    init = (
        jnp.asarray(bounce_start, dtype=jnp.int32),
        st.pos,
        st.direction,
        st.throughput,
        st.radiance,
        st.alive,
        st.primary_miss,
        st.w_mis,
        st.work_class,
    )
    if unroll is not None:
        state = init
        for _ in range(unroll):
            new_state = body(state)
            in_window = state[0] < bounce_stop  # scalar: step counts?
            state = jax.tree_util.tree_map(
                lambda a, b: jnp.where(in_window, b, a), state, new_state
            )
    else:
        state = jax.lax.while_loop(cond, body, init)
    return TraceState(
        pos=state[1],
        direction=state[2],
        wavelength=wavelength,
        lambda_pdf=lambda_pdf,
        throughput=state[3],
        radiance=state[4],
        w_mis=state[7],
        alive=state[5],
        primary_miss=state[6],
        work_class=state[8],
        rng=rng_keys,
    )


def classify_primary(st: TraceState, scale, cfg: TraceConfig) -> TraceState:
    """Analytic bounce-0 pre-kill + workload classing (params.binned_stage1).

    Pre-kill: a camera ray whose far atmosphere-shell root is non-positive
    never enters the atmosphere — no volume events (reference
    pathtracer.py:180-184: the RMO span is empty), no land hit (terrain lies
    inside the shell), so its outcome is exactly the primary miss the bounce
    loop would assign it (reference pathtracer.py:441-444). Marking it dead
    up front lets the stage compactor pack sky lanes into tiles the
    per-tile liveness cond skips entirely (~60% of an Apollo frame).

    Class (certified cost proxy from the ray's perigee radius, the f32-stable
    cross-product form): 0 = disk interior (steep descent, short march),
    1 = limb band (grazing near-terrain rays — the worst-lane march/track
    population), 2 = atmosphere-only graze (tracking, no march). Classes are
    clipped into [0, work_bins); the compactor's class binning then gives
    every bounce-0 tile a homogeneous iteration profile, exactly like the
    tail stages (TraceState.work_class docs)."""
    pos, direction = st.pos, st.direction
    a_near, a_far = mu.rsi(pos, direction, C.ATMOS_UPPER_LIMIT)
    enters = a_far > 0.0
    cr = jnp.cross(pos, direction)
    h2 = jnp.sum(cr * cr, axis=-1)
    b0 = mu.dot(pos, direction)
    # min radius along t >= 0: the line perigee when it lies ahead, else |pos|
    p = jnp.where(b0 < 0.0, jnp.sqrt(h2), mu.length(pos))
    cls = jnp.where(
        p < C.PLANET_R - 100e3,
        0,
        jnp.where(p < C.PLANET_R + scale, 1, 2),
    ).astype(jnp.int32)
    return st._replace(
        alive=st.alive & enters,
        primary_miss=st.primary_miss | (st.alive & ~enters),
        work_class=jnp.clip(cls, 0, cfg.work_bins - 1),
    )


def shade_primary_miss(st: TraceState, scene, atlas, luts, cfg) -> TraceState:
    """Miss shading: sun disk + stars for primary-miss lanes (reference
    pathtracer.py:455-463). Valid once bounce 0 has run: miss lanes never
    scatter, so ``st.direction`` is still the primary ray direction and
    their throughput/w_mis froze at the miss.

    A primary miss happens at bounce 0 where the hero throughput is 1, but
    packet companions carry their null-collision pdf ratios (the per-lambda
    transmittance estimate of the escape), so throughput multiplies in.
    """
    final_denom = jnp.maximum(
        jnp.sum(st.lambda_pdf * st.w_mis, axis=-1), 1e-12
    )[:, None]
    sun_power = sp.plancks(C.SUN_TEMPERATURE, st.wavelength)
    sun_hit = st.primary_miss & (
        jnp.sum(scene.light_direction * st.direction, axis=-1)
        > scene.sun_cos_angle
    )
    radiance = st.radiance + jnp.where(
        sun_hit[:, None], st.throughput * sun_power / final_denom, 0.0
    )
    stars_srgb = tx.sample_dir_texture(
        atlas.stars, st.direction, cfg.bilinear_materials
    )
    stars_power = sp.srgb_to_spectrum(
        luts.srgb2spec, stars_srgb[:, None, :], st.wavelength
    )
    radiance = radiance + jnp.where(
        st.primary_miss[:, None],
        st.throughput * stars_power * sun_power * C.STARS_SCALE / final_denom,
        0.0,
    )
    return st._replace(radiance=radiance)


def finalize_radiance(st: TraceState):
    """NaN/Inf/negative clamp (reference pathtracer.py:466-467)."""
    return jnp.where(
        jnp.isfinite(st.radiance) & (st.radiance >= 0.0), st.radiance, 0.0
    )


@partial(jax.jit, static_argnames=("cfg",))
def trace_paths(key, ray_pos, ray_dir, wavelength, scene: SceneParams, atlas, luts,
                cfg: TraceConfig = TraceConfig(), lambda_pdf=None,
                lane_ids=None):
    """Trace one spectral path per lane (single-stage wavefront).

    Hero-wavelength packets (Wilkie et al. 2014): each path carries L
    wavelengths; the hero (index 0) drives all sampling decisions, companions
    ride along with per-collision pdf-ratio weights, and every contribution
    is MIS-balanced over "which member is hero" (rotations of the spectral
    domain are measure-preserving, so the balance denominator is
    sum_k p_lambda(lambda_k) * W_k with W_k the tracked pdf ratios).
    L = 1 reduces exactly to the reference's single-wavelength estimator
    (reference renderer.py:310, pathtracer.py:316-469).

    Args:
      key: PRNG key for this wavefront.
      ray_pos, ray_dir: (N, 3) camera rays.
      wavelength: (N,) or (N, L) wavelengths in nm (member 0 = hero).
      lambda_pdf: (N, L) CIE sampling density of each member (same units as
        spectrum_sample's pdf). Defaults to 1 — then the L=1 return value is
        raw radiance, matching the pre-packet API where the caller divides
        by the pdf.
      lane_ids: (N,) integer ids folded into ``key`` to derive per-lane RNG
        streams (ops/rng.py); pass global pixel indices to make the result
        independent of how a frame was cut into trace_paths calls. Defaults
        to ``arange(N)``.

    Returns:
      (N,) radiance if wavelength was 1-D, else (N, L) MIS-weighted
      per-wavelength radiance estimates (already divided by the spectral
      pdfs; multiply by the CIE responses and sum over L for XYZ).
    """
    squeeze = wavelength.ndim == 1
    if squeeze:
        wavelength = wavelength[:, None]
    if lane_ids is None:
        lane_ids = jnp.arange(ray_pos.shape[0])
    st = init_state(ray_pos, ray_dir, wavelength, lambda_pdf,
                    rng_keys=rng.lane_keys(key, lane_ids))
    st = run_bounces(st, scene, atlas, luts, cfg, 0, cfg.max_bounces)
    st = shade_primary_miss(st, scene, atlas, luts, cfg)
    radiance = finalize_radiance(st)
    if squeeze:
        return radiance[:, 0]
    return radiance
