"""Scene/trace parameter pytrees (mirrors reference lib/parameters.py:4-15,
and the static trace budgets of pathtracer.py)."""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax.numpy as jnp

from .. import constants as C


class SceneParams(NamedTuple):
    """Traced per-frame scene parameters (reference lib/parameters.py:10-15).

    All fields are jnp scalars/vectors so changing them never recompiles.
    """

    light_direction: jnp.ndarray  # (3,)
    sun_cos_angle: jnp.ndarray
    sun_angular_radius: jnp.ndarray
    land_height_scale: jnp.ndarray


def make_scene_params(
    sun_angle: float = C.DEFAULT_SUN_ANGLE,
    sun_path_rot: float = C.DEFAULT_SUN_PATH_ROT,
    land_height_scale: float = C.DEFAULT_LAND_HEIGHT_SCALE,
) -> SceneParams:
    """Light direction from the two sun sliders (reference renderer.py:293-302)."""
    sun_angle = jnp.asarray(sun_angle, dtype=jnp.float32)
    sun_path_rot = jnp.asarray(sun_path_rot, dtype=jnp.float32)
    sun_rot = jnp.stack([-jnp.sin(sun_path_rot), jnp.cos(sun_path_rot)])
    light_direction = jnp.concatenate(
        [-jnp.sin(sun_angle)[None], jnp.cos(sun_angle) * sun_rot]
    )
    return SceneParams(
        light_direction=light_direction,
        sun_cos_angle=jnp.asarray(C.SUN_COS_ANGLE, dtype=jnp.float32),
        sun_angular_radius=jnp.asarray(C.SUN_ANGULAR_RADIUS, dtype=jnp.float32),
        land_height_scale=jnp.asarray(land_height_scale, dtype=jnp.float32),
    )


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """Static trace budgets (jit-static; changing any field recompiles).

    Defaults mirror the reference budgets (pathtracer.py:37,349,448); the
    tracking-step caps bound the delta/ratio-tracking while-loops, which the
    reference leaves unbounded (their expected step count is max_extinction *
    path length; the caps are safety nets well above that).
    """

    max_bounces: int = C.MAX_BOUNCES
    land_march_steps: int = C.LAND_MARCH_STEPS
    max_tracking_steps: int = 8192
    enable_clouds: bool = True
    enable_land: bool = True
    rr_start: int = C.RUSSIAN_ROULETTE_START
    # Filtering of the *in-loop* texture taps (land march SDF, cloud density
    # during tracking). The reference bilinearly filters everything
    # (lib/math_utils.py:44); nearest taps quarter the gather volume of the
    # hot loops at sub-texel visual cost, so they are the default here.
    bilinear_tracking: bool = False
    # Filtering of per-bounce material/stars lookups (reference-faithful).
    bilinear_materials: bool = True
    # Speculative free-flight steps drawn per tracking-loop iteration (one
    # batched texture gather resolves all of them).
    tracking_k: int = 4
    # Speculative probes per land-march iteration (same batching idea; the
    # march amortizes its fixed gather latency over more probes).
    march_k: int = 4
    # Scalar ray geometry in the march body: every probe sits on the fixed
    # ray pos + t*dir with |dir| = 1, so dot(ro, dir) = b0 + t, |ro|^2 =
    # h2 + (b0 + t)^2 and every in-loop ray-sphere test collapses to ONE
    # sqrt of (r^2 - h2) with the per-lane constants b0 = dot(pos, dir),
    # h2 = |pos|^2 - b0^2 hoisted out of the loop; the base-sphere root is
    # fully hoisted. Removes all (k, n, 3) intermediates and ~halves the
    # loop body's op count. Same math to ~15 m (the reassociated quadratic's
    # rounding, far below the march's t*1e-4 convergence epsilon); False =
    # the literal ro = pos + t*dir form for A/B validation. (Default False
    # until a GPU A/B decides it; the flip regenerates the goldens.)
    scalar_ray_geom: bool = False
    # March step floor, as a fraction of a texel arc. The floor is the
    # march's only UNCERTIFIED step (f-steps detect penetration by sign,
    # regional mip skips are certified), so it is a tunneling window:
    # terrain crossings narrower along-ray than floor*texel can be hopped
    # without either probe dipping inside — grazing secondary bounce rays
    # are the exposed population, and because grazing-crossing widths scale
    # with the texel, the bias is a function of the FRACTION, not the
    # absolute floor. Measured (Apollo 192 spp/arm vs the floor-free naive
    # march, docs/PARITY.md): 0.25 -> -5.6% +- 1.7 luminance; 0.02 ->
    # -1.1% +- 1.7 (zero within noise), but the powered round-4/5 battery
    # resolved a floor-linear apollo-B bias under 0.02 (-1.39/-1.50 +-
    # 0.55). PRODUCTION DEFAULT 0.005 (round 5, the production-floor
    # decision in docs/PARITY.md): the CRN-paired battery at 0.005 reads
    # every apollo channel inside the 1% gate (B -0.57 +- 0.55); a
    # secondary-only 0.005 floor was measured INSUFFICIENT (B -1.50 +- 0.55
    # — the bias rides primary grazing limb rays too), and the
    # fully-certified march (march_certified_floor + uncert 1e-6, the only
    # config that also fixes wrong-crossing hit distances) is several times
    # costlier and stays a validation config. The tight-mip regional skip
    # carries the certified progress the old floor was papering over.
    march_floor_frac: float = 0.005
    # Separate (smaller) floor for the BOUNCE > 0 primary marches: round-4
    # march-level instrumentation (docs/PARITY.md) shows the floor-linear
    # tunneling bias rides secondary (grazing hemisphere-sampled) rays —
    # bounce-0 hit/miss classification agrees with the floor-free naive
    # march on 99.9% of lanes. A tight secondary floor was meant to buy
    # the 0.005-ladder fidelity (apollo B -0.55% +- 0.55, inside the gate)
    # at a fraction of the global-0.005 cost. None = use march_floor_frac
    # everywhere. The any-hit shadow march always uses the
    # primary floor (exonerated bit-identically in the round-4 bisection).
    # Round-5 battery: a secondary-only 0.005 floor (primary 0.02) was
    # measured INSUFFICIENT for the apollo-B gate (B -1.50 +- 0.55) — the
    # production default is the blanket 0.005 primary floor above, and
    # this stays None (a bisection/experiment knob).
    march_floor_frac_secondary: "float | None" = None
    # Certified floor hops (round 5): before applying the
    # uncertified floor step, test whether the ray's analytic minimum radius
    # over the hop segment [t, t + floor] stays above ANY of the three
    # regional max-height bound spheres already gathered for the skip logic
    # (their validity radii 8/25/115 km dwarf the sub-texel hop, and the
    # test is pure arithmetic on the shared ray quadratic — zero extra
    # taps). A certified hop cannot tunnel: terrain under the segment lies
    # below a sphere the segment provably clears. Uncertified probes (ray
    # below every regional bound — the grazing-crossing population the
    # floor-linear apollo-B bias rides, docs/PARITY.md round 4) fall back
    # to march_uncert_floor_frac, buying 0.005-ladder fidelity only where
    # tunneling is geometrically possible instead of taxing every
    # secondary march.
    march_certified_floor: bool = False
    march_uncert_floor_frac: float = 0.005
    # Reference phantom-hit semantics (round 5, the florida-R mechanism):
    # the reference march (pathtracer.py:27-46) counts ANY ray whose
    # 250-step crawl ends inside 10 planet radii as a land hit — including
    # near-tangent escape rays that exhaust the budget climbing out of a
    # sub-km perigee well and "hit" tens of thousands of km above the
    # surface, where the reference then shades terrain. The wavefront march
    # bounds the march to the displaced surface's shell and correctly
    # misses them; this flag re-creates the reference outcome for the
    # march's miss lanes with a gather-free h=0 crawl emulation
    # (pathtracer._phantom_crawl). Default True: the parity gate is
    # measured against the reference's semantics, ghost limb ring and all.
    march_ref_phantom: bool = True
    # Hero-wavelength packet size: wavelengths traced per path (Wilkie et al.
    # 2014 spectral MIS). 1 = the reference's single-wavelength estimator;
    # 4 amortizes the path's geometry/tracking over 4 spectral samples,
    # collapsing chroma noise for ~1.2x the cost.
    hero_lambdas: int = 4
    # Stratify the per-pixel primary dimensions (subpixel jitter u/v, hero
    # wavelength u) across spp with an R3 low-discrepancy sequence under a
    # per-pixel Cranley-Patterson rotation: each pixel's spp sequence is a
    # randomized QMC point set (unbiased; the rotation is the randomizer),
    # so texture/spectral noise integrates ~O(1/N) instead of O(1/sqrt N)
    # on smooth regions. Deeper path dimensions stay independent. False =
    # the reference's independent-uniform jitter.
    stratify_spp: bool = True
    # NEE transmittance through the RMO gases from the precomputed
    # density-integral table (models/atmosphere_lut.py): exact closed form,
    # zero variance, no tracking loop. False falls back to ratio tracking
    # (the reference's estimator, pathtracer.py:117-143) for validation.
    analytic_transmittance: bool = True
    # RMO free-flight events by exact CDF inversion on the same table
    # (fixed-count Newton/bisection, no per-step RNG, no worst-lane
    # divergence) instead of delta tracking. Distribution-identical to the
    # reference's delta tracker up to tabulation error. Default OFF: the
    # fixed 14-iteration inversion does more work than the local-majorant
    # delta tracker's typical 2-4 rounds; not yet measured on a GPU.
    analytic_flight: bool = False
    flight_newton_iters: int = 14
    # In-loop RNG for the accelerated trackers: True = counter-based double
    # lowbias32 hash of the per-lane key (ops/rng.fast_uniform, ~11 int ops
    # per u32), False = per-iteration threefry fold + draw (~40+ ops/u32),
    # the tracking-loop bodies' single largest op group. Either way draws
    # are deterministic, layout-
    # independent pure functions of (spp, pixel, bounce, site, iteration).
    # The naive reference-faithful twins always use jax.random, so
    # tests/test_tracking_equiv.py statistically validates the fast
    # generator's distributions against them.
    fast_loop_rng: bool = False
    # Reference-faithful mode: one-step global-majorant trackers and the
    # plain sphere march (render/tracking_naive.py) instead of the
    # accelerated implementations. Slower; for parity checks and debugging.
    naive_tracking: bool = False
    # Fine-grained naive-ification (parity bisection): swap ONE accelerated
    # subsystem for its reference-faithful twin while the rest stays
    # accelerated. naive_march also disables the any-hit shadow variant;
    # naive_cloud_tracking swaps both the cloud delta and ratio passes
    # (cloud extinction is wavelength-flat, so packets still work).
    naive_march: bool = False
    naive_cloud_tracking: bool = False
    # Shadow-ray-only bisection: surface-NEE occlusion via the naive march
    # while the primary march stays accelerated (naive_march swaps BOTH, so
    # it cannot attribute a bias between them).
    naive_shadow: bool = False
    # Exact analytic ocean termination in the march (intersect_land): a
    # zero regional max turns the probe's base-sphere intersection into the
    # exact surface hit. False replaces it with ordinary convergence — a
    # parity-bisection knob for attributing the florida-R accelerated-march
    # bias (docs/PARITY.md round 5), not a production setting.
    march_exact_ocean: bool = True
    # Oscillation-stall termination patience: lanes whose march advances by
    # < floor/4 for this many consecutive sweeps terminate as hits at the
    # current t (they are grinding a boundary the relative epsilon cannot
    # close; see intersect_land). Large values effectively disable stall
    # termination (lanes burn the 250-probe budget and still count as hits
    # per the reference's budget-exhaustion semantics) — a parity-bisection
    # knob for attributing march bias, not a production setting.
    march_stall_patience: int = 2
    # March-on-demand: track free flights first (against the base-sphere
    # cap) and run the land march only for lanes whose event falls outside
    # the terrain-free ball one topo tap certifies at the ray origin.
    # In-cloud multi-scatter bounces over ocean/lowland (the dominant deep
    # workload) skip the march entirely. False restores the reference's
    # march-first order.
    lazy_march: bool = True
    # Next-event estimation Russian roulette on deep bounces: past
    # nee_rr_start, each lane runs the NEE shadow track only with
    # probability nee_rr_prob (contribution reweighted by 1/prob —
    # unbiased). Masked tracking loops run at worst-lane pace, so thinning
    # lanes inside a wavefront tile need not free any time. Off by default;
    # not yet measured on a GPU.
    nee_rr_start: int = C.MULTISCATTER_BOUNCE
    nee_rr_prob: float = 1.0
    # Deep-cloud path Russian roulette: cloud albedo 0.99 keeps throughput
    # ~1, so the reference's throughput-driven roulette
    # (pathtracer.py:448-453) almost never kills in-cloud lanes and the
    # bounce 8-24 multi-scatter tail is a large share of the frame cost.
    # From bounce cloud_rr_start,
    # in-cloud lanes continue with probability cloud_rr_keep and are
    # reweighted by 1/keep — exactly unbiased; killed lanes are compacted
    # out between stages, shrinking the tail tile count. 1.0 disables.
    cloud_rr_start: int = C.MULTISCATTER_BOUNCE
    cloud_rr_keep: float = 1.0
    # Two-level scheduling: run the bounce loop in stages and compact alive
    # lanes between them, so tiles of terminated lanes exit immediately
    # instead of pacing the worst lane through all 25 bounces. Stage 1 covers
    # [0, compact_after); later stages cover compact_every bounces each over
    # compact_tile-lane tiles of the compacted wavefront. compact_after=0
    # disables staging (single-stage tiles, the round-1 behavior).
    # Defaults: stage 1 = the coherent primary bounce only, then 6-bounce
    # stages; each stage pays a fixed full-wavefront compaction (O(n)
    # gathers over every state leaf) plus a stage sweep, so fewer, wider
    # stages amortize it. Untuned on the GPU: retuning needs a trace.
    compact_after: int = 1
    compact_every: int = 6
    # Frame-wide class-binned scheduling from bounce 0 (round 5): instead of
    # tracing bounce 0 inside spatially-coherent pixel-block tiles, generate
    # every camera ray up front, analytically pre-kill atmosphere-missing
    # rays (pathtracer.classify_primary — ~60% of an Apollo frame dies
    # before tracing anything), bin the rest by a perigee-radius cost class,
    # and run bounce 0 through the same compacted-stage machinery as the
    # tail. Motivation (tools/loop_cost.py measures it): where the
    # march/tracker while-loops are latency-bound — cost flat in lane width
    # — the binding cost is (number of tiles) x (worst-lane trip count),
    # and class-homogeneous tiles beat spatial blocks on both factors.
    binned_stage1: bool = False
    # Tail compact-tile budget: the renderer picks the largest 128-aligned
    # divisor of the wavefront <= this. Fine class-binned tail tiles
    # minimize worst-lane pacing of the tracking loops and skip dead tiles
    # sooner, against per-tile op-overhead amortization. Untuned on the
    # GPU: retuning needs a trace.
    compact_tile: int = 2048
    # stage-compaction workload bins: 3 = cloud/gas/surface; 5 additionally
    # splits cloud lanes by slab-core vs slab-edge and gas lanes by low vs
    # high altitude, so each tail tile's tracking-iteration profile is more
    # uniform (loops run at worst-lane pace). Output is bin-invariant
    # (binning only permutes lanes; RNG is per-lane).
    work_bins: int = 3
    # DIAGNOSTIC ONLY (biased-dark): skip next-event estimation entirely —
    # no sun cone sampling, no NEE transmittance tracking, no shadow march.
    # Sizes the NEE share of a frame for a perf decomposition; never
    # enabled in a shipping path.
    nee_off: bool = False
    # Straggler narrowing of the per-lane while loops (march + all three
    # trackers): after loop_narrow_after full-width iterations, the still-
    # live lanes are compacted into a loop_narrow-lane buffer and the loop
    # finishes there — bit-identical output (the loop bodies are per-lane
    # element-wise with per-lane RNG; narrowing only changes which lanes
    # share a gather op). Shipped OFF: where a loop iteration's cost is
    # insensitive to lane width (fixed op overhead dominates), narrowing
    # saves nothing and its permute/cond overhead is pure cost. Not yet
    # measured on a GPU. 0 disables.
    loop_narrow: int = 0
    loop_narrow_after: int = 2
