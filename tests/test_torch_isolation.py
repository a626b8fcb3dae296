"""The port stands alone: no JAX, no reference package, no silent CPU.

- ``ray_tpu_torch`` (every module) and ``chip_smoke.py`` import in a
  subprocess where importing jax, jaxlib, flax, optax or ray_tpu raises;
- an AST scan finds no import of those packages in the port's files;
- every entry point resolves to CUDA unless the caller passes
  ``device="cpu"``, and raises when there is no CUDA device (the
  evaluate CLI too);
- the ``Algorithm``'s surface (callbacks, ``tune/trainable.py``,
  ``util/atomic_io.py``, the evaluate CLI) imports with the reference
  blocked, and a port checkpoint saves and comes back through
  ``Algorithm.from_checkpoint`` in that state.
"""

from __future__ import annotations

import ast
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "jaxlib", "flax", "optax", "ray_tpu")


def _port_files():
    return sorted((REPO / "ray_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_port_imports_with_reference_blocked():
    code = textwrap.dedent(
        f"""
        import importlib, pkgutil, sys

        BLOCKED = {BLOCKED!r}

        class _Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError(name + " blocked by test")
                return None

        sys.meta_path.insert(0, _Block())
        import ray_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            ray_tpu_torch.__path__, "ray_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
        assert not bad, bad
        print(len(names))
        """
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.strip()) >= 20


def test_checkpoint_round_trip_with_reference_blocked(tmp_path):
    code = textwrap.dedent(
        f"""
        import sys

        class _Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in {BLOCKED!r}:
                    raise ImportError(name + " blocked by test")
                return None

        sys.meta_path.insert(0, _Block())
        import numpy as np
        import ray_tpu_torch.evaluate, ray_tpu_torch.algorithms.callbacks
        import ray_tpu_torch.tune.trainable, ray_tpu_torch.util.atomic_io
        from ray_tpu_torch.algorithms.algorithm import Algorithm
        from ray_tpu_torch.algorithms.ppo.ppo import PPOConfig

        algo = (PPOConfig().environment("CartPoleJax-v0", env_backend="jax")
                .rollouts(num_envs_per_worker=4, rollout_fragment_length=8)
                .training(train_batch_size=32, sgd_minibatch_size=16, num_sgd_iter=1,
                          model={{"fcnet_hiddens": [8]}})
                .debugging(seed=0).resources(device="cpu").build())
        algo.train()
        path = algo.save({str(tmp_path / "ckpt")!r})
        back = Algorithm.from_checkpoint(path, device="cpu")
        want, got = algo.get_policy().get_weights(), back.get_policy().get_weights()
        assert all(np.array_equal(want[k], got[k]) for k in want) and back.iteration == 1
        bad = [m for m in sys.modules if m.split(".")[0] in {BLOCKED!r}]
        assert not bad, bad
        print("ok")
        """
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stdout + proc.stderr


def test_evaluate_cli_raises_without_cuda(monkeypatch, tmp_path):
    from ray_tpu_torch import evaluate

    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="none is available"):
        evaluate.main([str(tmp_path), "--run", "PPO", "--env", "CartPole-v1", "--episodes", "1"])


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_reference_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            roots = [(node.module or "").split(".")[0]]
        else:
            continue
        assert not set(roots) & set(BLOCKED), (
            f"{path.name}:{node.lineno} imports {roots}"
        )


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_raises_without_cuda(monkeypatch):
    from ray_tpu_torch.device import resolve_device

    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_policy_without_device_raises_without_cuda(monkeypatch):
    from ray_tpu_torch.algorithms.ppo.ppo import PPOTorchPolicy
    from ray_tpu_torch.env.spaces import Box, Discrete

    _no_cuda(monkeypatch)
    obs, act = Box(-1, 1, (4,), np.float32), Discrete(2)
    with pytest.raises(RuntimeError, match="no CUDA|none is available"):
        PPOTorchPolicy(obs, act, {})
    pol = PPOTorchPolicy(obs, act, {}, device="cpu")
    assert pol.params[0].device.type == "cpu"


def test_algorithm_without_device_raises_without_cuda(monkeypatch):
    from ray_tpu_torch.algorithms.ppo.ppo import PPOConfig

    _no_cuda(monkeypatch)
    cfg = PPOConfig().environment("PongLiteJax-v0", env_backend="jax")
    with pytest.raises(RuntimeError, match="none is available"):
        cfg.build()
    algo = cfg.resources(device="cpu").build()
    assert algo.get_policy().device.type == "cpu"


def test_kernel_wrappers_refuse_other_devices():
    from ray_tpu_torch.ops.flash_attention import flash_attention, flash_block_attention_stats
    from ray_tpu_torch.ops.framestack import gather_rows
    from ray_tpu_torch.ops.gae import compute_gae_fragment

    src = torch.empty((4, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        gather_rows(src, torch.zeros(2, dtype=torch.int64, device="meta"))
    x = torch.empty((2, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        compute_gae_fragment(x, x, x, x.bool(), x.bool())
    qkv = torch.empty((1, 2, 8, 32), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention(qkv, qkv, qkv, causal_offset=0)
    with pytest.raises(ValueError, match="unsupported device"):
        flash_block_attention_stats(qkv[0], qkv[0], qkv[0], 0)


def test_sac_without_device_raises_without_cuda(monkeypatch):
    from ray_tpu_torch.algorithms.sac.sac import SACConfig, SACTorchPolicy
    from ray_tpu_torch.env.spaces import Box

    _no_cuda(monkeypatch)
    obs, act = Box(-1, 1, (3,), np.float32), Box(-2, 2, (1,), np.float32)
    with pytest.raises(RuntimeError, match="none is available"):
        SACTorchPolicy(obs, act, {})
    with pytest.raises(RuntimeError, match="none is available"):
        SACConfig().environment("Pendulum-v1").build()
    algo = SACConfig().environment("Pendulum-v1").resources(device="cpu").build()
    assert algo.get_policy().device.type == "cpu"
    assert algo.local_replay_buffer.device.type == "cpu"


def test_multi_agent_ppo_runs_with_reference_and_gymnasium_blocked():
    """The slice's modules import, and a multi-agent PPO iteration on the
    port's CartPole-v1 runs, with the reference and gymnasium blocked."""
    code = textwrap.dedent(
        f"""
        import sys

        BLOCKED = {BLOCKED + ("gymnasium",)!r}

        class _Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError(name + " blocked by test")
                return None

        sys.meta_path.insert(0, _Block())
        import numpy as np
        from ray_tpu_torch.algorithms.ppo.ppo import PPOConfig
        from ray_tpu_torch.env.multi_agent_env import make_multi_agent
        from ray_tpu_torch.env.registry import register_env
        from ray_tpu_torch.env.spaces import Box, Discrete
        from ray_tpu_torch.evaluation import multi_agent_sampler, view_collector

        register_env("ma", lambda cfg: make_multi_agent("CartPole-v1")({{"num_agents": 2}}))
        space = Box(-np.inf, np.inf, (4,), np.float64)
        algo = (PPOConfig().environment("ma")
                .rollouts(num_rollout_workers=0, rollout_fragment_length=32)
                .training(train_batch_size=64, sgd_minibatch_size=32, num_sgd_iter=1,
                          model={{"fcnet_hiddens": [8]}})
                .multi_agent(policies={{"shared": (None, space, Discrete(2), {{}})}},
                             policy_mapping_fn=lambda aid, **kw: "shared")
                .resources(device="cpu").build())
        r = algo.train()
        assert np.isfinite(r["info"]["learner"]["shared"]["total_loss"])
        bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
        assert not bad, bad
        print("ok")
        """
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stdout + proc.stderr


def test_multi_agent_ppo_without_device_raises_without_cuda(monkeypatch):
    from ray_tpu_torch.algorithms.ppo.ppo import PPOConfig
    from ray_tpu_torch.env.spaces import Box, Discrete

    _no_cuda(monkeypatch)
    cfg = PPOConfig().environment("CartPole-v1").multi_agent(
        policies={"p0": (None, Box(-1, 1, (4,), np.float32), Discrete(2), {})},
        policy_mapping_fn=lambda aid, **kw: "p0")
    with pytest.raises(RuntimeError, match="none is available"):
        cfg.build()


def test_serving_plane_runs_with_reference_blocked(tmp_path):
    """``ray_tpu_torch.serve``, ``.ingress`` and ``.resilience`` import, and
    a port checkpoint serves through ``PolicyDeployment`` behind the
    router and the HTTP front door, with the reference and gymnasium
    blocked."""
    code = textwrap.dedent(
        f"""
        import json, sys, urllib.request

        BLOCKED = {BLOCKED + ("gymnasium",)!r}

        class _Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError(name + " blocked by test")
                return None

        sys.meta_path.insert(0, _Block())
        import ray_tpu_torch.resilience
        from ray_tpu_torch import ingress, serve
        from ray_tpu_torch.resilience import discovery, provider_notice
        from ray_tpu_torch.algorithms.ppo.ppo import PPOConfig

        algo = (PPOConfig().environment("CartPole-v1").rollouts(num_rollout_workers=0)
                .training(train_batch_size=64, model={{"fcnet_hiddens": [8]}})
                .resources(device="cpu").build())
        root = {str(tmp_path / "ckpts")!r}
        algo.save(root + "/checkpoint_000001")
        dep = serve.PolicyDeployment(root, max_batch_size=4, device="cpu", watch=False)
        router = ingress.CoalescingRouter("cp", [ingress.LocalReplica(dep)], max_batch_size=4)
        front = ingress.PolicyIngress().start()
        front.add_policy("cp", router)
        req = urllib.request.Request(front.url + "/v1/policy/cp/actions",
                                     data=json.dumps({{"obs": [0.0, 0.1, 0.0, -0.1]}}).encode(),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=60) as resp:
            out = json.loads(resp.read())
        assert out["action"] in (0, 1) and out["params_version"] == 1, out
        front.stop(); router.stop(); dep.stop()
        assert discovery.discover(root)[1].endswith("checkpoint_000001")
        bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
        assert not bad, bad
        print("ok")
        """
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stdout + proc.stderr


def test_serving_without_device_raises_without_cuda(monkeypatch, tmp_path):
    from ray_tpu_torch.algorithms.ppo.ppo import PPOConfig
    from ray_tpu_torch.serve.policy_server import PolicyDeployment, restore_policy

    algo = (PPOConfig().environment("CartPole-v1").rollouts(num_rollout_workers=0)
            .training(train_batch_size=64, model={"fcnet_hiddens": [8]})
            .resources(device="cpu").build())
    path = algo.save(str(tmp_path / "checkpoint_000001"))
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="none is available"):
        restore_policy(path)
    with pytest.raises(RuntimeError, match="none is available"):
        PolicyDeployment(path, watch=False)
    assert restore_policy(path, device="cpu")[0].device.type == "cpu"
