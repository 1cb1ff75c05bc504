"""Wavefront renderer with pixel-stationary ray regeneration.

The plain wavefront (`engine/wavefront.py`) advances a fixed (pixel,
sample) batch until *every* lane dies — but path lifetimes are heavy-
tailed: with Russian roulette most paths die within ~4 bounces while a
handful survive to ``max_depth``, so late iterations do full-width work
for a nearly empty batch.

This engine keeps a persistent pool of M lanes at ~100% utilization with
a *pixel-stationary* schedule: lane ℓ owns pixels {ℓ, ℓ+M, ℓ+2M, …} and
traces all their samples back to back. The moment a path terminates the
lane immediately starts its next sample (or its next pixel). Because each
lane accumulates its own pixel's radiance, the framebuffer needs **no
scatter** and no task queue/cumsum: finished pixels are written into
a ``[rounds, M]`` buffer with a one-hot row add, and the final image is a
reshape. Lane workloads average over rounds × ns paths, so load imbalance
is negligible.

Correctness is unchanged: the counter-based RNG is keyed by
(pixel, sample, bounce), independent of lane scheduling, so each path's
radiance is bit-identical to the plain engine's; only the per-pixel
summation order differs (float associativity ~1e-7).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from tpu_pathtracer.camera import Camera
from tpu_pathtracer.config import RenderConfig
from tpu_pathtracer.engine.wavefront import (BounceState, Stats,
                                              bounce_step, make_view)
from tpu_pathtracer.models.scene import Scene
from tpu_pathtracer.ops.v3 import V3, where as vwhere


def _pool_size(config: RenderConfig, num_pixels: int) -> int:
    """Lane-pool size: ``config.rays_per_chunk`` or 32Ki lanes, capped at
    the pixel count. Smaller pools cover more pixels per lane, which
    averages away the heavy-pixel tail; bigger pools amortize the fixed
    per-iteration costs. The 32Ki default is not yet tuned for the GPU."""
    m = config.rays_per_chunk or (1 << 15)
    return int(min(m, num_pixels))


def render_regen(scene: Scene, camera: Camera, config: RenderConfig,
                 ns=None, pixel_offset: int = 0,
                 num_pixels: int | None = None, s0=0,
                 normalize: bool = True,
                 return_iters: bool = False):
    """Render ``[num_pixels, 3]`` radiance with a pixel-stationary pool.

    ``pixel_offset``/``num_pixels`` select a contiguous pixel range (the
    tile of this device); flat pixel ids remain global for RNG parity.
    ``ns`` may be a traced scalar (dynamic spp — one compile serves any
    sample count); ``s0`` offsets sample indices (checkpoint resume).
    ``normalize=False`` returns the radiance sum instead of the mean.
    """
    n = num_pixels if num_pixels is not None else config.num_pixels
    ns = jnp.asarray(config.ns if ns is None else ns, jnp.uint32)
    s0 = jnp.asarray(s0, jnp.uint32)
    m = _pool_size(config, n)
    rounds = (n + m - 1) // m
    inv_ns = (1.0 / ns.astype(jnp.float32)) if normalize else jnp.float32(1.0)

    fw = config.flush_window
    view = make_view(scene)
    pixel_offset = jnp.asarray(pixel_offset, jnp.uint32)
    # varying-zero seeds: carries must match the body's sharding varyance
    # under shard_map (pixel_offset is the per-device-varying input)
    zf = jnp.zeros((m,), jnp.float32) + (pixel_offset * jnp.uint32(0)
                                         ).astype(jnp.float32)
    zb = zf != 0.0
    lane = jnp.arange(m, dtype=jnp.uint32)
    round_iota = jnp.arange(rounds, dtype=jnp.int32)[:, None]  # [R,1]

    def pixel_of(rnd):
        return pixel_offset + lane + rnd.astype(jnp.uint32) * m

    def body(carry):
        (out_x, out_y, out_z, state, acc, cur_sample, rnd, bounce,
         done, iters, stats) = carry

        # ---- reap dead lanes: accumulate, maybe flush pixel, restart ----
        dead = ~state.alive & ~done
        if config.check_nans and config.stats:
            # per-path NaN count at reap time (kernels.cu:560); each path
            # is reaped exactly once so this matches the plain engine.
            isnan = dead & (jnp.isnan(state.color.x)
                            | jnp.isnan(state.color.y)
                            | jnp.isnan(state.color.z))
            stats = stats._replace(
                nans=stats.nans + jnp.sum(isnan, dtype=jnp.int32))
        acc = vwhere(dead, acc + state.color, acc)
        color = vwhere(dead, V3.zeros((m,)), state.color)

        want = dead & (cur_sample >= ns)           # pixel complete
        if fw and fw < rounds:
            # Sliding flush window: the full one-hot rewrites all
            # rounds x m out rows to flush a handful of lanes. Restrict the add to a W-row dynamic slice at
            # base = min live round — in-place dynamic_update_slice
            # traffic is W/rounds of the full rewrite. Lanes > W-1
            # rounds ahead of the slowest STALL their flush (the lane
            # idles until the window catches up); radiance sums are
            # bit-identical, only iteration counts can change. The
            # min-rnd lane is never stalled, so the loop always
            # progresses.
            base = jnp.clip(jnp.min(jnp.where(done, rounds, rnd)),
                            0, rounds - fw)
            flush = want & (rnd - base < fw)
            w_iota = jnp.arange(fw, dtype=jnp.int32)[:, None]
            onehot = (base + w_iota == rnd[None, :]) & flush[None, :]
            win_x = jax.lax.dynamic_slice(out_x, (base, 0), (fw, m))
            win_y = jax.lax.dynamic_slice(out_y, (base, 0), (fw, m))
            win_z = jax.lax.dynamic_slice(out_z, (base, 0), (fw, m))
            out_x = jax.lax.dynamic_update_slice(
                out_x, win_x + jnp.where(onehot, acc.x[None, :], 0.0),
                (base, 0))
            out_y = jax.lax.dynamic_update_slice(
                out_y, win_y + jnp.where(onehot, acc.y[None, :], 0.0),
                (base, 0))
            out_z = jax.lax.dynamic_update_slice(
                out_z, win_z + jnp.where(onehot, acc.z[None, :], 0.0),
                (base, 0))
        else:
            flush = want
            onehot = (round_iota == rnd[None, :]) & flush[None, :]
            out_x = out_x + jnp.where(onehot, acc.x[None, :], 0.0)
            out_y = out_y + jnp.where(onehot, acc.y[None, :], 0.0)
            out_z = out_z + jnp.where(onehot, acc.z[None, :], 0.0)
        acc = vwhere(flush, V3.zeros((m,)), acc)
        rnd = jnp.where(flush, rnd + 1, rnd)
        cur_sample = jnp.where(flush, 0, cur_sample)
        done = done | (dead & ((rnd >= rounds)
                               | (lane + rnd.astype(jnp.uint32) * m
                                  >= jnp.uint32(n))))

        # ---- start the next path on reaped, not-done lanes --------------
        # (stalled-flush lanes — want & ~flush — wait for the window)
        start = dead & ~done & ~(want & ~flush)
        pixel = pixel_of(rnd)
        start_sample = s0 + cur_sample
        o2, d2 = camera.generate_rays(pixel, start_sample,
                                      config.nx, config.ny)
        state = BounceState(
            origin=vwhere(start, o2, state.origin),
            direction=vwhere(start, d2, state.direction),
            color=color,
            attenuation=vwhere(start, V3.ones((m,)), state.attenuation),
            specular=jnp.where(start, False, state.specular),
            inside=jnp.where(start, False, state.inside),
            alive=state.alive | start,
            from_mesh=jnp.where(start, False, state.from_mesh),
        )
        bounce = jnp.where(start, 0, bounce)
        cur_sample = jnp.where(start, cur_sample + 1, cur_sample)

        # ---- one wavefront bounce ---------------------------------------
        # the sample being traced is the last one started
        trace_sample = s0 + cur_sample - jnp.uint32(1)
        state, new_stats = bounce_step(scene, view, config, state, pixel,
                                       trace_sample, bounce,
                                       stats if config.stats else None)
        if new_stats is not None:
            stats = new_stats
        bounce = bounce + 1
        if config.stats:
            # lanes killed by the depth cap == plain engine's alive-at-end
            killed = state.alive & (bounce >= config.max_depth)
            stats = stats._replace(
                exceed_max_bounce=stats.exceed_max_bounce
                + jnp.sum(killed, dtype=jnp.int32))
        state = state._replace(alive=state.alive & (bounce < config.max_depth))

        return (out_x, out_y, out_z, state, acc, cur_sample, rnd, bounce,
                done, iters + 1, stats)

    def cond(carry):
        done = carry[8]
        return ~jnp.all(done)

    zeros_rm = jnp.zeros((rounds, m), jnp.float32) + zf[None, :]
    zv = V3(zf, zf, zf)
    init_state = BounceState(
        origin=zv, direction=V3(zf, zf, zf + 1.0),
        color=zv, attenuation=V3(zf + 1, zf + 1, zf + 1),
        specular=zb, inside=zb, alive=zb, from_mesh=zb)
    zstat = jnp.sum(zf).astype(jnp.int32)  # varying scalar zero
    carry = (zeros_rm, zeros_rm, zeros_rm, init_state, zv,
             zf.astype(jnp.uint32), zf.astype(jnp.int32),
             zf.astype(jnp.int32), zb, jnp.int32(0),
             jax.tree.map(lambda x: x + zstat, Stats.zeros()))
    out = jax.lax.while_loop(cond, body, carry)
    out_x, out_y, out_z = out[0], out[1], out[2]

    flat = jnp.stack([out_x.reshape(-1), out_y.reshape(-1),
                      out_z.reshape(-1)], axis=-1)  # pixel p = r*M + lane
    fb = flat[:n] * inv_ns
    extras = []
    if return_iters:
        extras.append(out[9])
    if config.stats:
        extras.append(out[10])
    if extras:
        return (fb, *extras)
    return fb


@functools.partial(jax.jit, static_argnames=("config", "normalize"))
def _render_regen_jit(scene: Scene, camera: Camera, config: RenderConfig,
                      ns: jnp.ndarray, s0: jnp.ndarray = 0,
                      normalize: bool = True):
    """(``[num_pixels, 3]`` framebuffer, regen loop iterations)."""
    out = render_regen(scene, camera, config, ns=ns, s0=s0,
                       normalize=normalize, return_iters=True)
    return out[0], out[1]


def render_sample_range(scene: Scene, camera: Camera, config: RenderConfig,
                        s0: int, ns: int) -> np.ndarray:
    """Radiance SUM over samples [s0, s0+ns) for every pixel —
    [ny, nx, 3]. The building block for progressive/checkpointed renders:
    sums over disjoint ranges add up to exactly a straight run's sum."""
    fb, _ = _render_regen_jit(scene, camera, config, jnp.uint32(ns),
                              jnp.uint32(s0), normalize=False)
    return np.asarray(fb).reshape(config.ny, config.nx, 3)


def render_image_regen(scene: Scene, camera: Camera, config: RenderConfig,
                       ns: int | None = None) -> np.ndarray:
    """Full-frame render via the regeneration engine; returns
    [ny, nx, 3] linear mean radiance. ``ns`` overrides config.ns without
    recompiling (the sample count is a dynamic scalar)."""
    fb, _ = _render_regen_jit(scene, camera, config,
                              jnp.uint32(ns if ns is not None else config.ns))
    return np.asarray(fb).reshape(config.ny, config.nx, 3)
