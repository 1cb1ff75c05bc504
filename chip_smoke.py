"""Smoke run of the path tracer on NVIDIA GPUs, at the sizes users render.

    python chip_smoke.py               # one card
    python chip_smoke.py --four-cards  # the tiled, checkpointed 4K render

One card runs these phases, each at full size after its oracle gate (a
96x64, 4-spp, depth-8 render of the same scene family compared with the
independent NumPy renderer in ``tpu_pathtracer.oracle``):

  spheres    headline: random spheres 1200x800, 100 spp, depth 50,
             timed and compared with bench.py's committed golden crop
  staircase  procedural staircase (mesh, BVH, textures, NEE, roulette)
             1200x800, 8 spp, depth 64
  rocks      845k-triangle rock pile 512x512, 2 spp, depth 50, timed at
             leaf widths 8, 16 and 64
  entry      main.py's CLI on the headline frame, Renderer against the
             committed three-sphere golden, and the tiled regen render on
             one device against the single-device one

``--four-cards`` runs only the multi-device path: a 3840x2160 staircase
at 2 spp, tiled over four cards and checkpointed every sample, compared
with the one-card render of the same frame.

Per phase it prints compile seconds, timed seconds (``block_until_ready``),
ms/spp, Mpaths/s, regen iterations, the device's peak bytes in use so far
and ``memory_analysis()`` of the compiled regen program. The card's name
and power limit come from ``nvidia-smi`` in a child process that stays
off JAX. The last line is one JSON object naming the device; it is
printed only when every phase passed. The script refuses to run, and
exits non-zero, when the device is not a GPU or nvidia-smi is missing.
"""

from __future__ import annotations

import argparse
import functools
import json
import multiprocessing
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))

ONE_CARD_PHASES = ("spheres", "staircase", "rocks", "entry")
FOUR_CARD_PHASES = ("four_cards",)
LEAF_WIDTHS = (8, 16, 64)

# the frames (RenderConfig fields); each is one that users render
HEADLINE = dict(nx=1200, ny=800, ns=100, max_depth=50)
STAIRCASE = dict(nx=1200, ny=800, ns=8, max_depth=64)
ROCKS = dict(nx=512, ny=512, ns=2, max_depth=50, textures=False)
FOUR_CARDS = dict(nx=3840, ny=2160, ns=2, max_depth=64)


def phases(four_cards: bool) -> tuple:
    """The phases a run executes: the multi-device path alone with
    ``--four-cards``, else the one-card phases."""
    return FOUR_CARD_PHASES if four_cards else ONE_CARD_PHASES


def card_info() -> str:
    """``name, power.limit`` of every card, from nvidia-smi run in a
    child process (the parent's JAX client stays the only one on the
    card). Raises when nvidia-smi is missing or fails."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        raise RuntimeError("nvidia-smi not found: this script needs an "
                           "NVIDIA GPU")
    out = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def require_gpu(devices) -> None:
    """Refuse anything but a GPU: no fallback to another device."""
    if not devices or devices[0].platform != "gpu":
        kind = devices[0].platform if devices else "none"
        raise RuntimeError(f"chip_smoke needs a GPU; JAX found {kind!r}")


def result_line(devices) -> str:
    """The last line of a passing run."""
    return json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices)}})


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# oracle gates (host NumPy renders in CPU-only worker processes)
# ---------------------------------------------------------------------------


def _worker_init() -> None:
    os.environ["JAX_PLATFORMS"] = "cpu"


def _oracle(scene, cam, cfg, pixels):
    from tpu_pathtracer.oracle import render_oracle
    return render_oracle(scene, cam, cfg, pixels=pixels)


def _host(tree):
    import jax
    import numpy as np
    return jax.tree.map(np.asarray, tree)


# worker processes per oracle render (the brute-force mesh oracle is slow)
ORACLE_WORKERS = {"spheres": 1, "staircase": 2, "rocks": 8}


def gate_specs():
    """name -> (scene maker, gate config, rmse tolerance, SSIM minimum).
    The sizes and tolerances are bench.py's: looser for meshes, whose
    Moller-Trumbore form differs from the oracle's two-cross form."""
    from tpu_pathtracer.config import RenderConfig
    from tpu_pathtracer.models.mesh import procedural_staircase_scene
    from tpu_pathtracer.models.shapes import rocks_zoo_scene
    from tpu_pathtracer.models.spheres import random_spheres_scene

    g = RenderConfig(nx=96, ny=64, ns=4, max_depth=8)
    rocks = functools.partial(rocks_zoo_scene, n_big=2, n_small=3, seed=9)
    return {
        "spheres": (random_spheres_scene, g, 5e-3, 0.99),
        "staircase": (procedural_staircase_scene, g, 1e-2, 0.97),
        # the 845k-triangle pile's family on a 12.8k-triangle pile: the
        # brute-force oracle over the full pile would take hours
        "rocks": (rocks, g.replace(nx=64, ny=48, textures=False), 1e-2,
                  0.97),
    }


class Gates:
    """Starts every oracle render at once in worker processes (each
    frame split into pixel ranges), so the host renders overlap the
    device phases; ``check`` renders the gate frame on the device and
    compares."""

    def __init__(self, names):
        import numpy as np

        self.specs = gate_specs()
        self.pending = {}
        self.pool = None
        if not names:
            return
        ctx = multiprocessing.get_context("spawn")
        self.pool = ctx.Pool(sum(ORACLE_WORKERS[n] for n in names),
                             initializer=_worker_init)
        for name in names:
            make, cfg, _, _ = self.specs[name]
            scene, cam = make(cfg.nx, cfg.ny)
            ids = np.array_split(np.arange(cfg.num_pixels, dtype=np.uint32),
                                 ORACLE_WORKERS[name])
            self.pending[name] = [
                self.pool.apply_async(
                    _oracle, (_host(scene), _host(cam), cfg, part))
                for part in ids]

    def check(self, name) -> None:
        import numpy as np

        from tpu_pathtracer.utils import golden

        make, cfg, tol, ssim_min = self.specs[name]
        scene, cam = make(cfg.nx, cfg.ny)
        fn, _ = compile_frame(scene, cam, cfg)
        img, _, _ = run_frame(fn, scene, cam, cfg)
        ref = np.concatenate([job.get(timeout=1800)
                              for job in self.pending[name]])
        ref = ref.reshape(cfg.ny, cfg.nx, 3)
        err, ss = golden.rmse(img, ref), golden.ssim(img, ref)
        ok = err < tol and ss >= ssim_min and np.isfinite(img).all()
        log(f"[{name}] oracle gate {cfg.nx}x{cfg.ny} {cfg.ns}spp depth "
            f"{cfg.max_depth}: rmse {err:.3e} (< {tol}) ssim {ss:.5f} "
            f"(>= {ssim_min}) {'OK' if ok else 'FAILED'}")
        if not ok:
            raise AssertionError(f"oracle gate failed for {name}")

    def close(self) -> None:
        if self.pool is not None:
            self.pool.terminate()
            self.pool.join()


# ---------------------------------------------------------------------------
# timed frames
# ---------------------------------------------------------------------------


def compile_frame(scene, cam, cfg):
    """AOT-compile the regen render of ``cfg`` — the program behind
    ``render_image_regen`` and main.py. Returns (compiled, compile
    seconds)."""
    import jax.numpy as jnp

    from tpu_pathtracer.engine import regen

    t0 = time.perf_counter()
    compiled = regen._render_regen_jit.lower(
        scene, cam, cfg, jnp.uint32(cfg.ns), jnp.uint32(0)).compile()
    return compiled, time.perf_counter() - t0


def run_frame(compiled, scene, cam, cfg, ns=None):
    """One render; returns ([ny, nx, 3] mean radiance, iterations,
    seconds to ``block_until_ready``)."""
    import jax.numpy as jnp
    import numpy as np

    t0 = time.perf_counter()
    fb, iters = compiled(scene, cam, jnp.uint32(cfg.ns if ns is None
                                                else ns), jnp.uint32(0))
    fb.block_until_ready()
    secs = time.perf_counter() - t0
    return np.asarray(fb).reshape(cfg.ny, cfg.nx, 3), int(iters), secs


def _peak_bytes() -> int:
    import jax
    stats = jax.devices()[0].memory_stats() or {}
    return int(stats.get("peak_bytes_in_use", -1))


def _memory(compiled) -> str:
    m = compiled.memory_analysis()
    if m is None:
        return "memory_analysis n/a"
    return (f"memory_analysis temp {m.temp_size_in_bytes} B, args "
            f"{m.argument_size_in_bytes} B, out {m.output_size_in_bytes} B,"
            f" code {m.generated_code_size_in_bytes} B")


def timed_frame(tag, scene, cam, cfg):
    """Compile, warm up at 1 spp, then time one full render. Prints the
    phase metrics; returns the [ny, nx, 3] mean radiance."""
    import numpy as np

    compiled, csecs = compile_frame(scene, cam, cfg)
    run_frame(compiled, scene, cam, cfg, ns=1)
    img, iters, secs = run_frame(compiled, scene, cam, cfg)
    paths = cfg.nx * cfg.ny * cfg.ns
    log(f"[{tag}] {cfg.nx}x{cfg.ny} {cfg.ns}spp depth {cfg.max_depth}:"
        f" compile {csecs:.2f} s, {secs:.4f} s, "
        f"{secs / cfg.ns * 1e3:.3f} ms/spp, "
        f"{paths / secs / 1e6:.3f} Mpaths/s, {iters} iterations, "
        f"peak {_peak_bytes()} B, {_memory(compiled)}, "
        f"mean {img.mean():.5f}")
    if not np.isfinite(img).all():
        raise AssertionError(f"{tag}: non-finite radiance")
    return img


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def headline_config():
    from tpu_pathtracer.config import RenderConfig
    return RenderConfig(**HEADLINE)


def phase_spheres(gates) -> None:
    import bench
    from tpu_pathtracer.models.spheres import random_spheres_scene

    gates.check("spheres")
    cfg = headline_config()
    scene, cam = random_spheres_scene(cfg.nx, cfg.ny)
    img = timed_frame("spheres", scene, cam, cfg)
    bench.gate("spheres_100spp", img)  # the committed golden crop


def phase_staircase(gates) -> None:
    from tpu_pathtracer.config import RenderConfig
    from tpu_pathtracer.models.mesh import procedural_staircase_scene

    gates.check("staircase")
    cfg = RenderConfig(**STAIRCASE)
    scene, cam = procedural_staircase_scene(cfg.nx, cfg.ny)
    timed_frame("staircase", scene, cam, cfg)


def phase_rocks(gates) -> None:
    import numpy as np

    from tpu_pathtracer import native
    from tpu_pathtracer.config import RenderConfig
    from tpu_pathtracer.models.shapes import rocks_zoo_scene

    gates.check("rocks")
    log(f"[rocks] native BVH builder "
        f"{'loaded' if native.available() else 'NOT loaded: NumPy builder'}")
    cfg = RenderConfig(**ROCKS)
    imgs = {}
    for width in LEAF_WIDTHS:
        t0 = time.perf_counter()
        scene, cam = rocks_zoo_scene(cfg.nx, cfg.ny, prims_per_leaf=width)
        log(f"[rocks] leaf width {width}: {scene.mesh.num_tris} triangle "
            f"slots, scene + BVH built in "
            f"{time.perf_counter() - t0:.2f} s")
        imgs[width] = timed_frame(f"rocks leaf {width}", scene, cam, cfg)
    # the trees differ, the radiance must not (up to fp tie order)
    from tpu_pathtracer.utils import golden
    for width in LEAF_WIDTHS[1:]:
        err = golden.rmse(imgs[width], imgs[LEAF_WIDTHS[0]])
        log(f"[rocks] leaf {width} vs leaf {LEAF_WIDTHS[0]}: rmse {err:.3e}")
        if not err < 1e-3 or not np.isfinite(err):
            raise AssertionError("rock renders differ across leaf widths")


def phase_entry(gates) -> None:
    """The user-facing entry points on the card."""
    import jax
    import numpy as np

    import main as cli
    from tpu_pathtracer.config import RenderConfig
    from tpu_pathtracer.engine.regen import render_image_regen
    from tpu_pathtracer.engine.render import Renderer
    from tpu_pathtracer.models.spheres import three_sphere_scene
    from tpu_pathtracer.parallel.tiles import render_image_tiled_regen
    from tpu_pathtracer.utils import golden

    hc = headline_config()
    with tempfile.TemporaryDirectory() as td:
        png = os.path.join(td, "headline.png")
        t0 = time.perf_counter()
        cli.main(["--scene", "spheres", "--nx", str(hc.nx), "--ny",
                  str(hc.ny), "--ns", str(hc.ns), "--max-depth",
                  str(hc.max_depth), "-o", png])
        with open(png, "rb") as f:
            sig = f.read(8)
        log(f"[entry] main.py headline -> PNG ({os.path.getsize(png)} B) "
            f"in {time.perf_counter() - t0:.2f} s including compile")
        if sig != b"\x89PNG\r\n\x1a\n":
            raise AssertionError("main.py wrote no PNG")

    cfg = RenderConfig(nx=320, ny=200, ns=4, max_depth=50)
    scene, cam = three_sphere_scene(cfg.nx, cfg.ny)
    img = Renderer(scene, cam, cfg).run()
    ref = golden.load_reference(
        os.path.join(REPO, "assets", "three_sphere_320x200_4spp.ref"),
        cfg.nx, cfg.ny)
    err, ss = golden.rmse(img, ref), golden.ssim(img, ref)
    log(f"[entry] Renderer three-sphere 320x200 4spp vs committed golden: "
        f"rmse {err:.3e} ssim {ss:.5f}")
    if not (err < 5e-3 and ss > 0.98):
        raise AssertionError("Renderer disagrees with the golden")

    single = render_image_regen(scene, cam, cfg)
    tiled = render_image_tiled_regen(scene, cam, cfg,
                                     devices=jax.devices()[:1])
    diff = float(np.abs(single - tiled).max())
    log(f"[entry] tiled regen on one device vs render_image_regen: "
        f"max |diff| {diff:.3e}")
    if diff > 1e-6:
        raise AssertionError("tiled regen disagrees with the single render")


def phase_four_cards(gates) -> None:
    """BASELINE config 5's path: the tiled, checkpointed 4K staircase
    over four cards equals the one-card render of the same frame."""
    import jax
    import numpy as np

    from tpu_pathtracer.config import RenderConfig
    from tpu_pathtracer.engine.regen import render_image_regen
    from tpu_pathtracer.models.mesh import procedural_staircase_scene
    from tpu_pathtracer.parallel.tiles import render_tiled_regen
    from tpu_pathtracer.utils.checkpoint import render_with_checkpoints

    devices = jax.devices()
    if len(devices) != 4:
        raise RuntimeError(f"--four-cards needs 4 devices, found "
                           f"{len(devices)}")
    cfg = RenderConfig(**FOUR_CARDS)
    scene, cam = procedural_staircase_scene(cfg.nx, cfg.ny)

    t0 = time.perf_counter()
    render_tiled_regen(scene, cam, cfg, devices, ns=1).block_until_ready()
    log(f"[four_cards] tiled compile + 1-spp warm-up "
        f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    fb = render_tiled_regen(scene, cam, cfg, devices)
    shards = {s.device: s.data for s in fb.addressable_shards}
    done = {}
    while len(done) < len(shards):
        for dev, data in shards.items():
            if dev not in done and data.is_ready():
                done[dev] = time.perf_counter() - t0
        time.sleep(0.0005)
    owners = {dev.id for dev in fb.sharding.device_set}
    log(f"[four_cards] {cfg.nx}x{cfg.ny} {cfg.ns}spp tiled over devices {sorted(owners)}:"
        f" per-device wall " + ", ".join(
            f"{dev.id}: {t:.4f} s" for dev, t in sorted(
                done.items(), key=lambda kv: kv[0].id)))
    if len(owners) != 4:
        raise AssertionError(f"output came from {len(owners)} devices")
    tiled = np.asarray(fb)[:cfg.num_pixels].reshape(cfg.ny, cfg.nx, 3)

    with tempfile.TemporaryDirectory() as td:
        t0 = time.perf_counter()
        ck = render_with_checkpoints(scene, cam, cfg,
                                     os.path.join(td, "c5.ckpt"), batch=1,
                                     devices=devices)
        log(f"[four_cards] checkpointed every spp: "
            f"{time.perf_counter() - t0:.4f} s")

    t0 = time.perf_counter()
    single = render_image_regen(scene, cam, cfg)
    log(f"[four_cards] one-card render incl. compile "
        f"{time.perf_counter() - t0:.2f} s; peak {_peak_bytes()} B")
    for name, img in (("tiled", tiled), ("checkpointed", ck)):
        diff = float(np.abs(img - single).max())
        log(f"[four_cards] {name} vs one card: max |diff| {diff:.3e}")
        if not diff <= 1e-6:
            raise AssertionError(f"{name} 4-card render differs")


PHASES = {"spheres": phase_spheres, "staircase": phase_staircase,
          "rocks": phase_rocks, "entry": phase_entry,
          "four_cards": phase_four_cards}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the tiled, checkpointed 4K render on "
                        "four cards")
    args = p.parse_args(argv)

    card = card_info()
    import jax

    from tpu_pathtracer.utils.cache import enable_compilation_cache

    require_gpu(jax.devices())
    log(f"compile cache: {enable_compilation_cache()}")
    log(f"jax {jax.__version__}, devices {jax.devices()}")
    run = phases(args.four_cards)
    gates = Gates([n for n in run if n in gate_specs()])
    failed = []
    try:
        for name in run:
            t0 = time.perf_counter()
            try:
                PHASES[name](gates)
                log(f"[{name}] passed in {time.perf_counter() - t0:.1f} s")
            except Exception:  # report every phase, then fail the run
                traceback.print_exc()
                failed.append(name)
                log(f"[{name}] FAILED after {time.perf_counter() - t0:.1f}"
                    " s")
    finally:
        gates.close()
    log(f"card: {card}")
    if failed:
        log(f"failed phases: {failed}")
        return 1
    print(result_line(jax.devices()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
