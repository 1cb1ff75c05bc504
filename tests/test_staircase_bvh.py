"""Procedural staircase (axis-aligned boxes, many coplanar and
edge-sharing triangles): BVH-traversal exactness at every leaf width."""

import pytest

import bvh_cases
from tpu_pathtracer.models.mesh import procedural_staircase_mesh


@pytest.fixture(scope="module", params=bvh_cases.LEAF_WIDTHS)
def stairs_case(request):
    v0, v1, v2, tc, _ = procedural_staircase_mesh()
    # from around the reference camera (y≈174 looking down -z) into
    # the staircase volume
    o, d = bvh_cases.rays(256, 31, (100, 120, 500), (700, 400, 900),
                          (50, 0, -200), (750, 300, 300))
    return bvh_cases.case(v0, v1, v2, tc, request.param, o, d)


def test_staircase_traverse_nearest_vs_brute_force(stairs_case):
    bvh_cases.check_nearest(*stairs_case)


def test_staircase_traverse_anyhit_vs_brute_force(stairs_case):
    bvh_cases.check_anyhit(*stairs_case)
