#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``ray_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Runs from the repository root on a machine with one NVIDIA H100 (sm_90a)
and ``nvcc``. Phases, each printing its own lines:

1. build    -- compile every CUDA kernel from ``ray_tpu_torch/csrc``
               (one nvcc per source, started together);
2. gather   -- the row-gather kernel against its plain PyTorch version,
               bitwise, at the PPO bench geometry, at a ragged width and
               through ``build_stacks`` on uint8 frames; CUDA-event
               times of kernel, plain version and ``index_select``;
3. gae      -- the GAE kernel against its plain version, bitwise, at the
               device lane's (16, 128) and at ragged shapes with episode
               ends inside the fragment; times (no single PyTorch call
               computes this function, so there is no library time);
4. learner  -- ``PPOTorchPolicy.learn_on_batch`` twice on a frame-pool
               batch at the bench geometry (84x84x4, 6 actions, B=4096,
               minibatch 512, 10 epochs, lr 5e-5): env-steps/s, finite
               stats, and the row-gather launches of that run;
5. lane     -- ``PPO`` from tuned_examples/ppo/ponglitejax-ppo.yaml for 2
               training iterations on the device lane (N=16, T=128,
               minibatch 512, 6 epochs): reward, env-steps/s, the GAE
               launches of that run, and that params, env state and batch
               live on the card;
6. a ``{"kernels": [...]}`` line, the card's name and power limit, and
   as the last line ``{"ok": true, "device": {...}}``.

Launch counts are set to 0 just before phases 4 and 5 and read just
after; the comparison launches of phases 2 and 3 do not count. Any
failed check raises, and the script exits non-zero without printing a
result. Without a CUDA device it exits 1 at once.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published HBM3 rate
B, MB, ITERS = 4096, 512, 10  # the PPO learner bench geometry
H, W, C, NUM_ACTIONS = 84, 84, 4, 6
TUNED = os.path.join(REPO, "tuned_examples", "ppo", "ponglitejax-ppo.yaml")


def say(phase, **kv):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def require(cond, what):
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, iters=50, warmup=5):
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def make_frames(rng, n, h=H, w=W):
    """Blocky 84x84 single frames approximating Atari content."""
    import numpy as np

    base = rng.integers(0, 255, (n, h // 4, w // 4, 1), dtype=np.uint8)
    return np.kron(base, np.ones((1, 4, 4, 1), np.uint8))


def make_batch(rng):
    """A PPO train batch in the frame-pool format: rows are sliding
    C-frame stacks over one contiguous stream of B + C - 1 frames."""
    import numpy as np

    from ray_tpu_torch.ops.framestack import frame_stream_columns

    return {
        **frame_stream_columns(make_frames(rng, B + C - 1), B, C),
        "actions": rng.integers(0, NUM_ACTIONS, B).astype(np.int64),
        "action_logp": np.full(B, -1.79, np.float32),
        "action_dist_inputs": rng.standard_normal((B, NUM_ACTIONS)).astype(np.float32),
        "advantages": rng.standard_normal(B).astype(np.float32),
        "value_targets": rng.standard_normal(B).astype(np.float32),
    }


def phase_build():
    from ray_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    built = _kernels.build()
    secs = time.perf_counter() - t0
    for name, info in built.items():
        usage = [ln.strip() for ln in info["log"].splitlines() if "Used" in ln or "spill" in ln]
        say("build", kernel=name, seconds=f"{info['seconds']:.2f}",
            cached=info["cached"], ptxas=json.dumps(usage))
    say("build", total_seconds=f"{secs:.2f}")


def phase_gather(rng):
    import numpy as np
    import torch

    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.ops.framestack import build_stacks, gather_rows, gather_rows_plain

    dev = torch.device("cuda")
    # bench geometry: a (4099, 1764) word view of the uint8 pool, 16384 rows
    frames = torch.as_tensor(make_frames(rng, B + C - 1)).to(dev)
    pool = frames.reshape(frames.shape[0], -1).view(torch.int32)
    first = torch.arange(B, device=dev)
    idx = (first[:, None] + torch.arange(C, device=dev)).reshape(-1)
    out_k, out_p = gather_rows(pool, idx), gather_rows_plain(pool, idx)
    torch.cuda.synchronize()
    require(torch.equal(out_k, out_p), "row gather differs at the bench geometry")
    checked = [("bench", tuple(pool.shape), idx.numel())]
    # ragged widths (not a multiple of 4 words) and random indices
    for m, d, r in ((1000, 1763, 5000), (4099, 7, 333), (17, 1, 64)):
        src = torch.randint(-2**31, 2**31 - 1, (m, d), dtype=torch.int32, device=dev)
        ridx = torch.randint(0, m, (r,), device=dev)
        require(torch.equal(gather_rows(src, ridx), gather_rows_plain(src, ridx)),
                f"row gather differs at ({m}, {d}) x {r}")
        checked.append(("ragged", (m, d), r))
    # f32 store, 2-D index shape
    srcf = torch.randn(513, 100, device=dev)
    idx2 = torch.randint(0, 513, (40, 3), device=dev)
    require(torch.equal(gather_rows(srcf, idx2), gather_rows_plain(srcf, idx2)),
            "row gather differs on an f32 store")
    # uint8 stacks through build_stacks against plain indexing and numpy
    stacks = build_stacks(frames, first.to(torch.int32), C)
    plain = gather_rows_plain(frames, first[:, None] + torch.arange(C, device=dev))[..., 0].movedim(1, -1)
    require(torch.equal(stacks, plain), "build_stacks differs from plain indexing")
    from ray_tpu_torch.ops.framestack import materialize_stacks_np

    host = materialize_stacks_np(frames[:64].cpu().numpy(), np.arange(60), C)
    require(np.array_equal(build_stacks(frames, first[:60], C).cpu().numpy(), host),
            "build_stacks differs from the numpy materialisation")
    say("gather", bitwise=True, checked=json.dumps(checked))

    # the kernel's own time: raw launches on prepared buffers; the
    # wrapper adds host-side checks and an allocation per call
    lib = _kernels.library("row_gather")
    stream = torch.cuda.current_stream().cuda_stream
    ms = cuda_ms(lambda: lib.row_gather_launch(
        pool.data_ptr(), idx.data_ptr(), out_k.data_ptr(), idx.numel(),
        pool.shape[0], pool.shape[1], stream))
    wrapper_ms = cuda_ms(lambda: gather_rows(pool, idx))
    plain_ms = cuda_ms(lambda: gather_rows_plain(pool, idx))
    lib_ms = cuda_ms(lambda: torch.index_select(pool, 0, idx))
    stacks_ms = cuda_ms(lambda: build_stacks(frames, first, C))
    stacks_copy_ms = cuda_ms(lambda: build_stacks(frames, first, C).contiguous())
    # bytes the function must move: referenced pool rows read once, the
    # index read once, the output written once
    rows_read = int(torch.unique(idx).numel())
    nbytes = rows_read * pool.shape[1] * 4 + idx.numel() * 8 + out_k.numel() * 4
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    say("gather", ms=f"{ms:.5f}", wrapper_ms=f"{wrapper_ms:.5f}", plain_ms=f"{plain_ms:.5f}",
        index_select_ms=f"{lib_ms:.5f}",
        bound_ms=f"{bound_ms:.5f}", bytes=nbytes, gbps=f"{nbytes / ms / 1e6:.1f}")
    say("gather", build_stacks_ms=f"{stacks_ms:.5f}",
        build_stacks_contiguous_ms=f"{stacks_copy_ms:.5f}",
        note="build_stacks returns a permuted view; the _contiguous time adds a physical moveaxis")
    return {
        "name": "row_gather", "route": "cuda",
        "source": "ray_tpu_torch/csrc/row_gather.cu",
        "replaces": "ray_tpu/ops/framestack.py:65",
        "max_abs_err": 0.0, "ms": ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": lib_ms,
        "passed": True,
    }


def _gae_inputs(n, t, gen):
    import torch

    dev = torch.device("cuda")
    rewards = torch.randn(n, t, generator=gen, device=dev)
    values = torch.randn(n, t, generator=gen, device=dev)
    next_values = torch.randn(n, t, generator=gen, device=dev)
    term = torch.rand(n, t, generator=gen, device=dev) < 0.05
    trunc = torch.rand(n, t, generator=gen, device=dev) < 0.05
    trunc[:, -1] |= torch.rand(n, generator=gen, device=dev) < 0.5
    return rewards, values, next_values, term, term | trunc


def phase_gae():
    import torch

    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.ops.gae import compute_gae_fragment, compute_gae_fragment_plain

    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = [(16, 128), (1, 1), (3, 1), (5, 7), (33, 200), (257, 64)]
    worst = 0.0
    for n, t in shapes:
        args = _gae_inputs(n, t, gen)
        for gamma, lam in ((0.99, 0.95), (0.9, 1.0)):
            ak, vk = compute_gae_fragment(*args, gamma, lam)
            ap, vp = compute_gae_fragment_plain(*args, gamma, lam)
            torch.cuda.synchronize()
            worst = max(worst, float((ak - ap).abs().max()), float((vk - vp).abs().max()))
            require(torch.equal(ak, ap) and torch.equal(vk, vp),
                    f"GAE kernel differs from plain at ({n}, {t}), gamma={gamma}, lambda={lam}")
    say("gae", bitwise=True, shapes=json.dumps(shapes), max_abs_err=worst)

    args = _gae_inputs(16, 128, gen)
    adv, vt = torch.empty_like(args[0]), torch.empty_like(args[0])
    lib = _kernels.library("gae_scan")
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [a.data_ptr() for a in args] + [adv.data_ptr(), vt.data_ptr()]
    ms = cuda_ms(lambda: lib.gae_fragment_launch(*ptrs, 16, 128, 0.99, 0.99 * 0.95, stream),
                 iters=200)
    wrapper_ms = cuda_ms(lambda: compute_gae_fragment(*args, 0.99, 0.95), iters=200)
    plain_ms = cuda_ms(lambda: compute_gae_fragment_plain(*args, 0.99, 0.95), iters=20)
    nt = 16 * 128
    nbytes = 3 * nt * 4 + 2 * nt + 2 * nt * 4
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    say("gae", ms=f"{ms:.5f}", wrapper_ms=f"{wrapper_ms:.5f}", plain_ms=f"{plain_ms:.5f}",
        bound_ms=f"{bound_ms:.7f}",
        bytes=nbytes, library="none: no single PyTorch call computes this function",
        note="launch-latency bound")
    return {
        "name": "gae_scan", "route": "cuda",
        "source": "ray_tpu_torch/csrc/gae_scan.cu",
        "replaces": "ray_tpu/ops/gae.py:130",
        "max_abs_err": worst, "ms": ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None,
        "passed": True,
    }


def phase_learner(rng):
    import numpy as np
    import torch

    from ray_tpu_torch.algorithms.ppo.ppo import PPOTorchPolicy
    from ray_tpu_torch.env.spaces import Box, Discrete
    from ray_tpu_torch.ops.framestack import gather_rows

    policy = PPOTorchPolicy(
        Box(0, 255, (H, W, C), np.uint8), Discrete(NUM_ACTIONS),
        {"train_batch_size": B, "sgd_minibatch_size": MB, "num_sgd_iter": ITERS, "lr": 5e-5},
    )
    require(policy.params[0].is_cuda, "policy params are not on the card")
    batch = make_batch(rng)
    gather_rows.launches = 0
    times, stats = [], None
    for _ in range(2):
        t0 = time.perf_counter()
        stats = policy.learn_on_batch(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = gather_rows.launches
    require(launches >= 1, "learn_on_batch did not launch the row-gather kernel")
    require(all(math.isfinite(v) for v in stats.values()), f"non-finite learner stats {stats}")
    say("learner", env_steps_per_s=f"{B / times[1]:.1f}", call_s=json.dumps([round(t, 4) for t in times]),
        row_gather_launches=launches, peak_mem_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
    say("learner", stats=json.dumps({k: round(v, 6) for k, v in stats.items()}))
    return launches


def phase_lane():
    import torch

    from ray_tpu_torch.algorithms.ppo.ppo import PPOConfig
    from ray_tpu_torch.ops.gae import compute_gae_fragment
    from ray_tpu_torch.utils.tuned_example import load_tuned_example

    (exp,) = load_tuned_example(TUNED).values()
    cfg = PPOConfig().update_from_dict(exp["config"])
    cfg.env = exp["env"]
    algo = cfg.build()
    compute_gae_fragment.launches = 0
    results, times = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        results.append(algo.train())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = compute_gae_fragment.launches
    require(launches >= 1, "the device lane did not launch the GAE kernel")
    policy = algo.get_policy()
    eng = algo._rollout_engine
    # one more update, split into its two halves (host clock, synchronised)
    t0 = time.perf_counter()
    batch, bsize = eng.rollout()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    policy.learn_on_device_batch(eng.learn_batch(batch), bsize)
    torch.cuda.synchronize()
    split = {"rollout_s": round(t1 - t0, 4), "learn_s": round(time.perf_counter() - t1, 4)}
    on_card = (
        all(p.is_cuda for p in policy.params)
        and all(v.is_cuda for v in eng.carry["env"].values())
        and all(v.is_cuda for v in batch.values())
    )
    require(on_card, "params, env state or batch left the card")
    require(batch["obs"].shape == (bsize, 84, 84, 1), f"obs {tuple(batch['obs'].shape)}")
    for k in ("advantages", "value_targets", "vf_preds", "action_logp"):
        require(bool(torch.isfinite(batch[k]).all()), f"non-finite {k}")
    adv = batch["advantages"]
    require(abs(float(adv.mean())) < 1e-4 and abs(float(adv.std(unbiased=False)) - 1) < 1e-3,
            "advantages are not standardised")
    last = results[-1]
    learner = last["info"]["learner"]["default_policy"]
    require(all(math.isfinite(v) for v in learner.values()), f"non-finite learner stats {learner}")
    say("lane", episode_reward_mean=last["episode_reward_mean"],
        episodes=sum(r["episodes_this_iter"] for r in results),
        num_env_steps_sampled=last["num_env_steps_sampled"],
        env_steps_per_s=f"{bsize / times[1]:.1f}", iter_s=json.dumps([round(t, 4) for t in times]),
        gae_launches=launches, on_card=on_card, batch_size=bsize, split=json.dumps(split))
    say("lane", learner=json.dumps({k: round(v, 6) for k, v in learner.items()}))
    return launches


def card_line():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        out = f"nvidia-smi unavailable: {e}"
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to check", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import numpy as np

    from ray_tpu_torch.device import resolve_device

    resolve_device()
    say("env", python=sys.version.split()[0], torch=torch.__version__, cuda=torch.version.cuda,
        device=torch.cuda.get_device_name(0))
    rng = np.random.default_rng(0)
    phase_build()
    gather = phase_gather(rng)
    gae = phase_gae()
    gather["launches"] = phase_learner(rng)
    gae["launches"] = phase_lane()
    print(json.dumps({"kernels": [gather, gae]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
