# Frozen copy of rtf_tpu_torch/render/config.py at commit 224dbd1 (the benchmark's
# reference; imports rewritten to this tree, kernel launches removed).
"""Render configuration and per-project profiles.

The reference hardcodes its knobs as per-project `#define`s
(Final/main.cpp:19-32, lights.h:16-18, materials.h:20-25); each project
directory is effectively one config.  Here they are one frozen dataclass,
and `PROFILES` reproduces each project's settings.  A copy of
rtf_tpu/render/config.py: the port reads the same knobs.
"""
from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class RenderConfig:
    # ---- antialiasing (main.cpp:20-24, generateSample/VariantOverThreshold)
    min_samples: int = 4            # MIN_SAMPLE
    max_samples: int = 8            # MAX_SAMPLE
    variance_threshold: float = 1e-3  # THRESHOLD
    halton_base_x: int = 2          # HALTON_BASE_1
    halton_base_y: int = 3          # HALTON_BASE_2
    # escalation ladder: 0 = one jump min->max (Final/Proj10+ era,
    # `s_end = MAX_SAMPLE`); k>=2 = geometric rungs min, min*k, min*k^2
    # ... max with the variance re-checked on ALL accumulated hit
    # samples at each rung (Proj8/9 era `s_end *= 4`, main.cpp:283)
    adaptive_factor: int = 0

    # ---- recursion
    bounces: int = 4                # BOUNCE

    # ---- intersection epsilon era (sphere `zero`): Proj3/4 compare
    # the discriminant and t against literal 0 (Proj3 objects.h sphere),
    # Proj5+ against 0.001f — at 800x600 the 1e-3 floor clips ~1 px of
    # sphere silhouette, which is visible in deterministic 1-spp
    # comparisons (prj3c)
    isect_zero: float = 1e-3
    # fidelity switch: reference-exact intersection arithmetic — the
    # textbook sphere quadratic in the reference's op order (see
    # ops/intersect.py::intersect_sphere) AND secondary/shadow rays
    # shot from the hit point itself (the reference's bias is 0/1e-14,
    # relying on the per-primitive t epsilon) instead of the
    # normal-offset origin.  Oracle-comparison profiles only; leave
    # False for production (the stable quadratic + offset origin are
    # strictly more robust at grazing incidence / large scene scales)
    ref_exact: bool = False
    # Proj3-era sphere hit policy: z = min(t1,t2), rejected when z < 0
    # (no back hits at all — Proj3 main.cpp Sphere::IntersectRay)
    sphere_minroot: bool = False

    # ---- direct lighting
    light_average: bool = True      # Final's coef = 1/numLights (main.cpp:545)
    inverse_square: bool = True     # point-light 1/r^2 falloff (lights.h:130)
    shadow_min: int = 4             # MIN_SHADOW_SAMPLES (lights.h:17)
    shadow_max: int = 16            # MAX_SHADOW_SAMPLES (lights.h:18)

    # ---- depth of field (main.cpp:19,246-262)
    cam_samples: int = 64           # CAM_SAMPLE lens table size

    # ---- GI
    gi_mode: str = "none"           # none | hemisphere | pathtrace | photon
    hemisphere_samples: int = 30    # HEMISPHERE_SAMPLE
    photon_count: int = 1_000_000   # MAX_NUM_OF_PHOTON
    photon_bounces: int = 8         # PHOTON_BOUNCE
    caustic_count: int = 1_000_000
    caustic_bounces: int = 5
    # caustic kNN radius (the commented-out estimate in the reference
    # uses 0.5, RayTracingProj13/.../main.cpp:521)
    caustic_radius: float = 0.5
    knn_k: int = 400                # EstimateIrradiance<400> (main.cpp:699)
    knn_radius: float = 1.0
    # hemisphere samples per DISPATCH on the fused host-chunked GI path
    # (bounds per-dispatch runtime at full resolution)
    gi_dispatch_chunk: int = 4
    # photon estimates via the precomputed irradiance volume
    # (gi/volume.py) on the fused path; False = exact per-point hash-grid
    # gathers on the XLA path
    photon_volume: bool = True
    # stratify the hemisphere fan-out's azimuth: chunk i draws phi in
    # the i-th of S strata (per-lane jitter inside the stratum).
    # Unbiased and lower-variance than independent phi, and it makes
    # each chunk's child rays direction-coherent by construction on
    # normal-coherent lane blocks (lanes ride in pixel order, so flat
    # surfaces share frames) — which is what lets the per-lane slab
    # tile culls work on GI rays.  Fused paths only; the XLA
    # wavefront keeps the reference's independent sampling.
    gi_stratify: bool = True
    # group hemisphere child rays by mesh-root-AABB interest (+ octant)
    # before the child wave: a pure lane permutation that makes lane
    # blocks homogeneous so the per-lane slab tile culls actually skip
    # work on incoherent GI rays (profile: mesh sweeps are ~100% of the
    # per-hemi-sample cost on scene_b).  Same rays, same estimator —
    # but NOT the same RNG streams: in-kernel streams are keyed on
    # (block seed, lane position), so the permutation reassigns them,
    # and block composition changes which blocks escalate the
    # block-adaptive shadow sampling (shadow_max fires only for blocks
    # containing penumbra lanes).  Toggling this therefore shifts
    # RNG-consuming renders at the noise level (unbiased); don't read
    # golden-image diffs or resumed checkpoints that mix the two
    # settings as regressions (ADVICE r3).
    gi_mesh_sort: bool = True

    # ---- ray-differential texture filtering (opt-in quality; the
    # reference's Texture::Sample elliptic filter, scene.h:331-349 +
    # the disabled calculateduvw, RayTracingProj7 objects.h:81-87 —
    # dead code there because duvw stays 0; live here when enabled)
    tex_filter: bool = False
    tex_filter_samples: int = 32    # TEXTURE_SAMPLE_COUNT (scene.h:18)

    # environment sampled on reflection-ray miss too (Proj8-era Shade,
    # RayTracingProj8 main.cpp:382-384); Final restricts it to refraction
    env_on_reflect_miss: bool = False
    # angular-map xy normalization era quirk: Proj7's SampleEnvironment
    # uses the Euclidean norm (Proj7 scene.h:461-463), Proj8+ the L1
    # norm |x|+|y| (Final scene.h:428-430)
    env_l2: bool = False

    # ---- output
    gamma: float = 2.2              # 0/None disables (pre-proj11 projects)
    # thresholds (materials.h:20-25)
    total_reflection_threshold: float = 1.001
    color_threshold: float = 0.001

    # ---- wavefront engine
    queue_factor: float = 1.0       # secondary-queue capacity / primary rays
    # Fresnel split handling: 'both' follows reflection AND refraction like
    # the reference recursion (top-k compacted queues, exact); 'rr' keeps
    # each lane following ONE Russian-roulette-chosen child with unbiased
    # reweighting — lane==pixel stays a static permutation, so the whole
    # wave runs scatter-free (the TPU-native choice for MC configs).
    # 'auto' = 'rr' when min_samples >= 8 else 'both'.
    split_mode: str = "auto"
    seed: int = 0

    def resolved_split_mode(self) -> str:
        if self.split_mode == "auto":
            return "rr" if self.min_samples >= 8 else "both"
        return self.split_mode

    def with_(self, **kw) -> "RenderConfig":
        return replace(self, **kw)


PROFILES = {
    # Proj3: primary + Blinn + hard shadows, 1 spp, no gamma, no recursion
    "proj3": RenderConfig(min_samples=1, max_samples=1, bounces=0,
                          light_average=False, inverse_square=False,
                          shadow_min=1, shadow_max=1, gamma=0.0,
                          isect_zero=0.0, ref_exact=True,
                          sphere_minroot=True),
    # Proj4-6: + reflections/refractions (Whitted), still 1 spp
    "proj5": RenderConfig(min_samples=1, max_samples=1, bounces=5,
                          light_average=False, inverse_square=False,
                          shadow_min=1, shadow_max=1, gamma=0.0,
                          env_on_reflect_miss=True),
    # Proj7: textures, 1 spp, no AA; its SampleEnvironment normalizes
    # the xy projection with the Euclidean norm (scene.h:461-463) —
    # the only era that does
    "proj7": RenderConfig(min_samples=1, max_samples=1, bounces=5,
                          light_average=False, inverse_square=False,
                          shadow_min=1, shadow_max=1, gamma=0.0,
                          env_on_reflect_miss=True, env_l2=True),
    # Proj8: adaptive AA 4..64 (4 -> 16 -> 64 ladder, `s_end *= 4`)
    "proj8": RenderConfig(min_samples=4, max_samples=64, bounces=5,
                          adaptive_factor=4,
                          light_average=False, inverse_square=False,
                          shadow_min=1, shadow_max=1, gamma=0.0,
                          env_on_reflect_miss=True),
    # Proj10: soft shadows + glossy (still no falloff/gamma — PointLight
    # returns intensity*shadow with no 1/r^2, Proj10 lights.h:66-89)
    "proj10": RenderConfig(min_samples=4, max_samples=64, bounces=5,
                           light_average=False, inverse_square=False,
                           gamma=0.0, env_on_reflect_miss=True),
    # Proj11: MC GI (hemisphere at first hit), gamma 2.2
    "proj11": RenderConfig(min_samples=4, max_samples=16, bounces=4,
                           gi_mode="hemisphere", hemisphere_samples=20),
    # Proj12: path tracing — 1 indirect sample per bounce, many AA samples
    "proj12": RenderConfig(min_samples=4, max_samples=16, bounces=8,
                           gi_mode="pathtrace", hemisphere_samples=1),
    # Proj13 / Final: hybrid GI — 30-sample hemisphere at the first
    # bounce, photon-map kNN estimate deeper (Final/main.cpp:19-32),
    # adaptive 4->8 AA, adaptive 4->16 soft shadows, gamma 2.2
    "final": RenderConfig(min_samples=4, max_samples=8, bounces=4,
                          gi_mode="photon", hemisphere_samples=30,
                          shadow_min=4, shadow_max=16),
    "photon": RenderConfig(gi_mode="photon", hemisphere_samples=30),
}
