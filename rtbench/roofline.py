"""A kernel's least time from the bytes its algorithm needs.

A ray tracer's operations depend on the data (how far a walk goes, how
many faces a ray meets), so the bound is bytes only: what the algorithm
must read and write at least, counted from its inputs and outputs and never
from the port's table layouts or its kernels' own counters, so that a
change of layout or traversal cannot move the yardstick.

Per ray, its input record once and its output record once.  Per launch,
the scene data the algorithm needs, once: a face is its three corners (9
floats); a sphere, a plane and a mesh instance are a world-to-local 3x3
matrix, a position and a material id (13); a light is its kind,
intensity, direction, position and size (11); a material its diffuse,
specular, emission, reflection and refraction colours, absorption,
glossiness, two gloss widths and index of refraction (22); a texel its
three channels.  Floats and ids are 4 bytes.
"""
from __future__ import annotations

# published peak of one NVIDIA H100 SXM (data sheet; at a 700 W limit)
HBM_BYTES_PER_S = 3.35e12
WORD = 4

WAVE_IN = 7   # origin 3, direction 3, alive 1
WAVE_STATE = 7  # a child wave's throughput 3, absorption 3, ray type 1
WAVE_OUT = 5  # radiance 3, hit 1, z 1
SURF_ROWS = 12  # first-hit position, normal, kd, k_eff
GI_ROWS = 9   # a bounce's photon query: position, normal, weight
FACE = 9
INSTANCE = 13
LIGHT = 11
MATERIAL = 22
TEXEL = 3


def scene_words(facts: dict) -> int:
    """Words of scene data a wave reads once: every primitive, light and
    material, the faces and, on a textured scene, the texels.
    facts: `scene_facts` of the run."""
    return (FACE * facts["faces"]
            + INSTANCE * (facts["spheres"] + facts["planes"]
                          + facts["mesh_instances"])
            + LIGHT * facts["lights"] + MATERIAL * facts["materials"]
            + (TEXEL * facts["texels"] if facts["textured"] else 0))


def wave_bytes(rays: int, state: bool, surf_out: bool, gi_bounces: int,
               facts: dict) -> int:
    """Bytes of one wave-kernel launch over `rays` lanes: each lane's ray
    (and a child wave's state) in, its radiance, hit and z (and the rows
    asked for) out, and the scene once."""
    per_ray = (WAVE_IN + (WAVE_STATE if state else 0) + WAVE_OUT
               + (SURF_ROWS if surf_out else 0) + GI_ROWS * gi_bounces)
    return WORD * (rays * per_ray + scene_words(facts))


def least_seconds(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S


def share(least_s: float, device_s: float):
    """A roofline share in %, or None where the kernel did not run."""
    if device_s <= 0.0 or least_s <= 0.0:
        return None
    return 100.0 * least_s / device_s
