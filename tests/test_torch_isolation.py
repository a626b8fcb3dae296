"""The port stands alone: no JAX, no reference package, no silent CPU.

- ``ray_tpu_torch`` (every module) and ``chip_smoke.py`` import in a
  subprocess where importing jax, jaxlib, flax, optax or ray_tpu raises;
- an AST scan finds no import of those packages in the port's files;
- every entry point resolves to CUDA unless the caller passes
  ``device="cpu"``, and raises when there is no CUDA device.
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
