"""scene_build_s: seconds of the scene's build in set-up (host clock,
synchronised): `build_scene`, `scene_tables` (the MXU tables on a large
mesh) and, where the cell walks a BVH, `ensure_bvh` and the walk's tables.
Moves setup_s."""


def read(run):
    return run.spans.get("scene_build_s")
