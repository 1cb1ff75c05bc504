"""Camera ray generation + image/texture utilities."""

import os

import jax.numpy as jnp
import numpy as np

from tpu_pathtracer.camera import make_camera, staircase_camera
from tpu_pathtracer.ops import texture as T
from tpu_pathtracer.utils import image as im


def test_camera_basis_matches_reference_ctor():
    # helper_structs.h:194–206 with simple inputs
    cam = make_camera((0, 0, 0), (0, 0, -1), (0, 1, 0), 90.0, 2.0,
                      aperture=0.0, focus_dist=1.0)
    np.testing.assert_allclose(np.asarray(cam.w), [0, 0, 1], atol=1e-6)
    np.testing.assert_allclose(np.asarray(cam.u), [1, 0, 0], atol=1e-6)
    np.testing.assert_allclose(np.asarray(cam.v), [0, 1, 0], atol=1e-6)
    # vfov 90 → half_height=1, aspect 2 → half_width 2
    np.testing.assert_allclose(np.asarray(cam.lower_left_corner),
                               [-2, -1, -1], atol=1e-5)
    np.testing.assert_allclose(np.asarray(cam.horizontal), [4, 0, 0], atol=1e-5)
    np.testing.assert_allclose(np.asarray(cam.vertical), [0, 2, 0], atol=1e-5)


def test_rays_unit_and_through_image_plane():
    nx, ny = 16, 8
    cam = make_camera((0, 0, 0), (0, 0, -1), (0, 1, 0), 90.0, 2.0)
    pid = jnp.arange(nx * ny, dtype=jnp.uint32)
    o, d = cam.generate_rays(pid, jnp.uint32(0), nx, ny)
    o = np.asarray(o.stack())
    d = np.asarray(d.stack())
    np.testing.assert_allclose(np.linalg.norm(d, axis=-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(o, 0.0, atol=1e-6)
    # pixel (0,0) is bottom-left → dir x<0, y<0; top-right → x>0, y>0
    assert d[0, 0] < 0 and d[0, 1] < 0
    assert d[-1, 0] > 0 and d[-1, 1] > 0


def test_staircase_camera_values():
    cam = staircase_camera(640, 800)
    np.testing.assert_allclose(np.asarray(cam.origin),
                               [5.555139, 173.679901, 494.515045], atol=1e-5)
    assert float(cam.lens_radius) == 0.0


def test_lens_aperture_spreads_origins():
    cam = make_camera((0, 0, 0), (0, 0, -1), (0, 1, 0), 90.0, 1.0,
                      aperture=0.5, focus_dist=3.0)
    pid = jnp.arange(256, dtype=jnp.uint32)
    o, d = cam.generate_rays(pid, jnp.uint32(0), 16, 16)
    r = np.linalg.norm(np.asarray(o.stack()), axis=-1)
    assert r.max() <= 0.25 + 1e-5  # lens_radius = aperture/2
    assert r.std() > 0.01


def test_linear_to_srgb_reference_formula():
    # staircase_scene.h:22–30
    assert im.linear_to_srgb_u8(np.array([0.0])) == 0
    assert im.linear_to_srgb_u8(np.array([1.0])) == 255
    x = np.array([0.5])
    want = min(int((1.055 * 0.5 ** 0.416666667 - 0.055) * 255.9), 255)
    assert im.linear_to_srgb_u8(x)[0] == want


def test_ppm_and_png(tmp_path):
    img = np.random.RandomState(0).rand(4, 6, 3).astype(np.float32)
    ppm = str(tmp_path / "o.ppm")
    png = str(tmp_path / "o.png")
    im.write_ppm(ppm, img)
    im.write_png(png, img)
    with open(ppm) as f:
        head = f.read().split()
    assert head[0] == "P3" and head[1] == "6" and head[2] == "4"
    assert os.path.getsize(png) > 0


def test_texture_atlas_fetch_wrap():
    imgs = [np.arange(12, dtype=np.float32).reshape(2, 2, 3) / 12.0,
            np.ones((3, 4, 3), np.float32) * 0.5]
    atlas, w, h = T.build_atlas(imgs)
    assert atlas.shape == (2, 3, 4, 3)
    out = T.fetch(jnp.asarray(atlas), jnp.asarray(w), jnp.asarray(h),
                  jnp.asarray([0, 0, 1]),
                  jnp.asarray([0.0, 1.7, 0.9]),   # 1.7 wraps to 0.7
                  jnp.asarray([0.0, 0.7, 0.2]))
    np.testing.assert_allclose(np.asarray(out[0]), imgs[0][0, 0], atol=1e-6)
    np.testing.assert_allclose(np.asarray(out[1]), imgs[0][0, 0], atol=1e-6)
    np.testing.assert_allclose(np.asarray(out[2]), 0.5, atol=1e-6)


def test_png_writer_round_trip(tmp_path):
    """The stdlib PNG writer: decode its chunks by hand and get back the
    sRGB bytes, top row first."""
    import struct
    import zlib

    from tpu_pathtracer.utils.image import linear_to_srgb_u8, write_png

    img = np.random.RandomState(0).rand(5, 7, 3).astype(np.float32) * 1.5
    path = str(tmp_path / "x.png")
    write_png(path, img)
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF
        chunks[tag] = chunks.get(tag, b"") + body
        pos += 12 + n
    w, h, depth, ctype = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    assert (w, h, depth, ctype) == (7, 5, 8, 2)
    raw = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    rows = raw.reshape(5, 1 + 7 * 3)
    assert (rows[:, 0] == 0).all()  # filter type None
    np.testing.assert_array_equal(rows[:, 1:].reshape(5, 7, 3),
                                  linear_to_srgb_u8(img)[::-1])
    assert b"IEND" in chunks
