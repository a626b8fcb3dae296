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
  ``Algorithm.from_checkpoint`` in that state;
- the recurrent models (``models/rnn.py``, ``models/attention.py``)
  import with the reference blocked, and recurrent PPO trains on them;
- the rest of off-policy (Rainbow DQN, DDPG, TD3, per-policy rings)
  trains with the reference blocked;
- the asynchronous actor-learner loop (Ape-X over device shards, the
  learner thread's fused superstep, ``AsyncSampler``) runs with the
  reference blocked, and Ape-X without a device raises;
- offline data and external envs (the JSON writer and reader, MARWIL,
  BC, CQL, CRR, ``BaseEnv``, ``SyntheticFast-v0``, the policy server and
  client) run with the reference and gymnasium blocked, and the offline
  algorithms without a device raise;
- the single-agent algorithms of item 9.3 (PG, A2C, A3C, SimpleQ, R2D2,
  RNNSAC, ES and ARS's rollout engine, the linear bandits) train with
  the reference and gymnasium blocked, and each raises without a
  device;
- the multi-agent and slate algorithms (MADDPG and QMIX on the port's
  copies of the coop envs that ``chip_smoke.py`` defines, QMIX's episode
  ring included, SlateQ on ``SyntheticSlate-v0``) train with the
  reference and gymnasium blocked, and each raises without a device.
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


def test_recurrent_models_run_with_reference_blocked():
    """``models/rnn.py`` and ``models/attention.py`` import with the
    reference blocked, and recurrent PPO trains through them."""
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
        import ray_tpu_torch.models.attention, ray_tpu_torch.models.rnn
        from ray_tpu_torch.algorithms.ppo.ppo import PPOConfig

        for model in ({{"use_lstm": True, "lstm_cell_size": 8, "fcnet_hiddens": [8],
                        "max_seq_len": 4}},
                      {{"use_attention": True, "attention_dim": 8, "attention_num_heads": 2,
                        "attention_head_dim": 4, "attention_memory_training": 3,
                        "attention_position_wise_mlp_dim": 8, "max_seq_len": 4}}):
            algo = (PPOConfig().environment("CartPole-v1")
                    .rollouts(num_rollout_workers=0, rollout_fragment_length=16)
                    .training(train_batch_size=16, sgd_minibatch_size=8, num_sgd_iter=1,
                              model=model)
                    .debugging(seed=0).resources(device="cpu").build())
            algo.train()
            state = algo.get_policy().get_initial_state()
            algo.compute_single_action(np.zeros(4, np.float32), state)
            algo.stop()
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


def test_off_policy_slice_runs_with_reference_blocked():
    """The slice's modules (``algorithms/ddpg/``, the Rainbow heads,
    ``Deterministic``, the noise explorations, n-step, frame pools in
    replay, per-policy rings) import with the reference blocked, and
    Rainbow DQN, DDPG, TD3 and two-policy DQN train through them."""
    code = textwrap.dedent(
        f"""
        import sys

        class _Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in {BLOCKED!r}:
                    raise ImportError(name + " blocked by test")
                return None

        sys.meta_path.insert(0, _Block())
        from ray_tpu_torch.algorithms.ddpg.ddpg import DDPGConfig, TD3Config
        from ray_tpu_torch.algorithms.dqn.dqn import DQNConfig
        from ray_tpu_torch.env.multi_agent_env import make_multi_agent
        from ray_tpu_torch.env import registry
        from ray_tpu_torch.env.spaces import Box, Discrete

        rainbow = dict(num_atoms=11, v_min=0.0, v_max=10.0, noisy=True, n_step=3,
                       train_batch_size=8, num_steps_sampled_before_learning_starts=8,
                       model={{"fcnet_hiddens": [8]}},
                       replay_buffer_config={{"prioritized_replay": True}})
        algo = (DQNConfig().environment("CartPole-v1").rollouts(rollout_fragment_length=8)
                .training(**rainbow).resources(device="cpu").build())
        for _ in range(3):
            algo.train()
        algo.stop()
        for cls in (DDPGConfig, TD3Config):
            algo = (cls().environment("Pendulum-v1")
                    .training(train_batch_size=8, num_steps_sampled_before_learning_starts=8,
                              actor_hiddens=[8], critic_hiddens=[8])
                    .resources(device="cpu").build())
            for _ in range(12):
                algo.train()
            assert algo.get_policy().num_updates > 0
            algo.stop()
        registry.register_env("mc", lambda c: make_multi_agent("CartPole-v1")({{"num_agents": 2}}))
        cfg = (DQNConfig().environment("mc").rollouts(rollout_fragment_length=8)
               .training(train_batch_size=8, num_steps_sampled_before_learning_starts=8,
                         model={{"fcnet_hiddens": [8]}})
               .resources(device="cpu"))
        space = Box(-10.0, 10.0, (4,))
        cfg.multi_agent(policies={{p: (None, space, Discrete(2), {{}}) for p in ("a", "b")}},
                        policy_mapping_fn=lambda aid, *a, **k: "ab"[aid % 2])
        algo = cfg.build()
        for _ in range(3):
            out = algo.train()
        assert set(out["info"]["learner"]) == {{"a", "b"}}
        algo.stop()
        bad = [m for m in sys.modules if m.split(".")[0] in {BLOCKED!r}]
        assert not bad, bad
        print("ok")
        """
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stdout + proc.stderr


def test_async_loop_runs_with_reference_blocked():
    """Ape-X (``algorithms/apex_dqn/``) trains over its device shards,
    IMPALA's learner thread takes fused supersteps and an
    ``AsyncSampler`` samples, with the reference blocked."""
    code = textwrap.dedent(
        f"""
        import sys, time

        class _Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in {BLOCKED!r}:
                    raise ImportError(name + " blocked by test")
                return None

        sys.meta_path.insert(0, _Block())
        from ray_tpu_torch.algorithms.apex_dqn.apex_dqn import ApexDQNConfig
        from ray_tpu_torch.algorithms.impala.impala import IMPALAConfig
        from ray_tpu_torch.algorithms.ppo.ppo import PPOTorchPolicy
        from ray_tpu_torch.data.sample_batch import concat_samples
        from ray_tpu_torch.env.registry import get_env_creator
        from ray_tpu_torch.env.vector_env import VectorEnv
        from ray_tpu_torch.evaluation.sampler import AsyncSampler
        from ray_tpu_torch.execution.learner_thread import LearnerThread

        algo = (ApexDQNConfig().environment("CartPole-v1")
                .rollouts(num_rollout_workers=0, rollout_fragment_length=8)
                .training(train_batch_size=8, num_steps_sampled_before_learning_starts=16,
                          target_network_update_freq=16, model={{"fcnet_hiddens": [8]}})
                .resources(device="cpu").build())
        for _ in range(6):
            algo.train()
        assert algo._counters["num_target_updates"] >= 1
        algo.stop()
        cfg = IMPALAConfig().update_from_dict({{
            "device": "cpu", "num_workers": 0, "rollout_fragment_length": 8,
            "train_batch_size": 16, "superstep": 2, "model": {{"fcnet_hiddens": [8]}}}})
        cfg.env = "CartPole-v1"
        algo = cfg.build()
        assert algo.train()["timesteps_total"] >= 16
        w = algo.workers.local_worker()
        batches = [concat_samples([w.sample(), w.sample()]) for _ in range(2)]
        algo.stop()
        lt = LearnerThread(algo.get_policy())
        for b in batches:  # a backlog of K = 2 before the thread starts
            lt.add_batch(b)
        lt.start()
        deadline = time.time() + 60
        while lt.num_steps < 2 and time.time() < deadline:
            time.sleep(0.05)
        lt.stop()
        assert lt.num_supersteps == 1, lt.error
        env = get_env_creator("CartPole-v1")
        policy = PPOTorchPolicy(env({{}}).observation_space, env({{}}).action_space,
                                {{"model": {{"fcnet_hiddens": [8]}}}}, device="cpu")
        sampler = AsyncSampler(vector_env=VectorEnv.vectorize_gym_envs(lambda i: env({{}}), 2),
                               policy=policy, rollout_fragment_length=8)
        assert sampler.sample().count == 16
        sampler.stop()
        bad = [m for m in sys.modules if m.split(".")[0] in {BLOCKED!r}]
        assert not bad, bad
        print("ok")
        """
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stdout + proc.stderr


def test_apex_without_device_raises_without_cuda(monkeypatch):
    from ray_tpu_torch.algorithms.apex_dqn.apex_dqn import ApexDQNConfig

    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="none is available"):
        ApexDQNConfig().environment("CartPole-v1").rollouts(num_rollout_workers=0).build()


def test_ddpg_without_device_raises_without_cuda(monkeypatch):
    from ray_tpu_torch.algorithms.ddpg.ddpg import DDPGTorchPolicy, TD3Config
    from ray_tpu_torch.env.spaces import Box

    _no_cuda(monkeypatch)
    obs, act = Box(-1, 1, (3,), np.float32), Box(-2, 2, (1,), np.float32)
    with pytest.raises(RuntimeError, match="none is available"):
        DDPGTorchPolicy(obs, act, {})
    with pytest.raises(RuntimeError, match="none is available"):
        TD3Config().environment("Pendulum-v1").build()
    algo = TD3Config().environment("Pendulum-v1").resources(device="cpu").build()
    assert algo.get_policy().device.type == "cpu"
    assert algo.get_policy().aux_state["step"].device.type == "cpu"


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


def test_offline_and_external_envs_run_with_reference_and_gymnasium_blocked(tmp_path):
    """The slice's modules (``offline/``, ``algorithms/marwil``, ``cql``,
    ``crr``, ``env/base_env.py``, ``synthetic_env.py``,
    ``policy_server_input.py``, ``policy_client.py``) import with the
    reference and gymnasium blocked; PPO and SAC write shards, MARWIL,
    BC, CQL and CRR train from them, and a client drives a server over
    SyntheticFast-v0 and a BaseEnv."""
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
        import types
        import numpy as np
        from ray_tpu_torch.algorithms.cql.cql import CQLConfig
        from ray_tpu_torch.algorithms.crr.crr import CRRConfig
        from ray_tpu_torch.algorithms.marwil.marwil import BCConfig, MARWILConfig
        from ray_tpu_torch.algorithms.ppo.ppo import PPOConfig
        from ray_tpu_torch.algorithms.sac.sac import SACConfig
        from ray_tpu_torch.env.base_env import convert_to_base_env
        from ray_tpu_torch.env.policy_client import PolicyClient
        from ray_tpu_torch.env.policy_server_input import PolicyServerInput
        from ray_tpu_torch.env.registry import get_env_creator

        tmp = {str(tmp_path)!r}
        ppo = (PPOConfig().environment("CartPole-v1")
               .rollouts(num_rollout_workers=0, rollout_fragment_length=32)
               .training(train_batch_size=32, sgd_minibatch_size=32, num_sgd_iter=1,
                         model={{"fcnet_hiddens": [8]}})
               .offline_data(output=tmp + "/cp").resources(device="cpu").build())
        ppo.train()
        for cfg in (MARWILConfig(), BCConfig()):
            algo = (cfg.environment("CartPole-v1").training(train_batch_size=32,
                    model={{"fcnet_hiddens": [8]}}).offline_data(input_=tmp + "/cp")
                    .resources(device="cpu").build())
            assert np.isfinite(algo.train()["info"]["learner"]["default_policy"]["policy_loss"])
            algo.stop()
        hidden = dict(policy_model_config={{"fcnet_hiddens": [8]}},
                      q_model_config={{"fcnet_hiddens": [8]}})
        sac = (SACConfig().environment("Pendulum-v1").rollouts(rollout_fragment_length=32)
               .training(train_batch_size=16, num_steps_sampled_before_learning_starts=10**9,
                         **hidden)
               .offline_data(output=tmp + "/pd").resources(device="cpu").build())
        sac.train()
        sac.stop()
        for cfg in (CQLConfig().training(bc_iters=1, num_actions=2, **hidden),
                    CRRConfig().training(n_action_sample=2, **hidden)):
            algo = (cfg.environment("Pendulum-v1").training(train_batch_size=16)
                    .offline_data(input_=tmp + "/pd").resources(device="cpu").build())
            for _ in range(2):
                info = algo.train()["info"]["learner"]["default_policy"]
            assert np.isfinite(info["critic_loss"])
            algo.stop()
        worker = types.SimpleNamespace(policy_map={{"default_policy": ppo.get_policy()}},
                                       preprocessor=None, filters={{}})
        server = PolicyServerInput(types.SimpleNamespace(worker=worker), "127.0.0.1", 0)
        client = PolicyClient(f"127.0.0.1:{{server.port}}")
        env = get_env_creator("SyntheticFast-v0")({{"obs_dim": 4, "num_actions": 2,
                                                    "episode_len": 5}})
        obs, _ = env.reset()
        eid = client.start_episode()
        done = False
        while not done:
            obs, r, term, done, _ = env.step(int(client.get_action(eid, obs)))
            client.log_returns(eid, r)
        client.end_episode(eid, obs, truncated=True)
        assert server.next().count == 5
        server.shutdown()
        ppo.stop()
        base = convert_to_base_env(env)
        obs = base.poll()[0]
        base.send_actions({{0: {{"agent0": 1}}}})
        bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
        assert not bad, bad
        print("ok")
        """
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stdout + proc.stderr


def test_offline_algorithms_without_device_raise_without_cuda(monkeypatch):
    from ray_tpu_torch.algorithms.cql.cql import CQLConfig
    from ray_tpu_torch.algorithms.crr.crr import CRRConfig
    from ray_tpu_torch.algorithms.marwil.marwil import BCConfig, MARWILConfig

    _no_cuda(monkeypatch)
    for cfg, env in ((MARWILConfig(), "CartPole-v1"), (BCConfig(), "CartPole-v1"),
                     (CQLConfig(), "Pendulum-v1"), (CRRConfig(), "Pendulum-v1")):
        with pytest.raises(RuntimeError, match="none is available"):
            cfg.environment(env).build()
        algo = cfg.resources(device="cpu").build()
        assert algo.get_policy().device.type == "cpu"
        algo.stop()


def test_single_agent_algorithms_run_with_reference_and_gymnasium_blocked():
    """PG, A2C, SimpleQ, R2D2, RNNSAC and both bandits train an
    iteration, A3C's gradient API steps the learner, and ES's rollout
    engine builds CartPole-v1 through the port's registry, with the
    reference and gymnasium blocked."""
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
        from ray_tpu_torch.algorithms.a2c.a2c import A2CConfig, A3CConfig
        from ray_tpu_torch.algorithms.bandit.bandit import (
            BanditLinTSConfig, BanditLinUCBConfig, LinearContextBandit)
        from ray_tpu_torch.algorithms.dqn.dqn import SimpleQConfig
        from ray_tpu_torch.algorithms.es.es import _RolloutEngine
        from ray_tpu_torch.algorithms.pg.pg import PGConfig
        from ray_tpu_torch.algorithms.r2d2.r2d2 import R2D2Config
        from ray_tpu_torch.algorithms.sac.rnnsac import RNNSACConfig

        small = {{"fcnet_hiddens": [8]}}
        cfgs = [
            PGConfig().environment("CartPole-v1").training(train_batch_size=64, model=small),
            A2CConfig().environment("CartPole-v1").training(train_batch_size=40, model=small),
            SimpleQConfig().environment("CartPole-v1").training(
                train_batch_size=8, num_steps_sampled_before_learning_starts=4, model=small),
            R2D2Config().environment("CartPole-v1").training(
                train_batch_size=2, num_steps_sampled_before_learning_starts=20,
                model={{"use_lstm": True, "lstm_cell_size": 8, "fcnet_hiddens": [8]}}),
            RNNSACConfig().environment("Pendulum-v1").rollouts(rollout_fragment_length=20).training(
                train_batch_size=40, num_steps_sampled_before_learning_starts=20,
                policy_model_config={{"fcnet_hiddens": [8], "lstm_cell_size": 4}},
                q_model_config={{"fcnet_hiddens": [8], "lstm_cell_size": 4}}),
            BanditLinUCBConfig().environment(LinearContextBandit),
            BanditLinTSConfig().environment(LinearContextBandit),
        ]
        for cfg in cfgs:
            algo = cfg.resources(device="cpu").build()
            for _ in range(3):
                r = algo.train()
            assert r["timesteps_total"] > 0, type(algo).__name__
            algo.stop()
        algo = A3CConfig().environment("CartPole-v1").training(model=small).resources(
            device="cpu").build()
        worker = algo.workers.local_worker()
        grads, info = worker.compute_gradients(worker.sample())
        worker.apply_gradients(grads)
        assert algo.get_policy().opt_state.count == 1 and np.isfinite(info["total_loss"])
        algo.stop()
        engine = _RolloutEngine({{"model": small}}, "CartPole-v1")
        ret, steps = engine.rollout(np.zeros(engine.num_params, np.float32))
        assert steps > 0
        bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
        assert not bad, bad
        print("ok")
        """
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stdout + proc.stderr


_SINGLE_AGENT = {
    "PG": ("ray_tpu_torch.algorithms.pg.pg", "PGConfig", "CartPole-v1"),
    "A2C": ("ray_tpu_torch.algorithms.a2c.a2c", "A2CConfig", "CartPole-v1"),
    "A3C": ("ray_tpu_torch.algorithms.a2c.a2c", "A3CConfig", "CartPole-v1"),
    "SimpleQ": ("ray_tpu_torch.algorithms.dqn.dqn", "SimpleQConfig", "CartPole-v1"),
    "R2D2": ("ray_tpu_torch.algorithms.r2d2.r2d2", "R2D2Config", "CartPole-v1"),
    "RNNSAC": ("ray_tpu_torch.algorithms.sac.rnnsac", "RNNSACConfig", "Pendulum-v1"),
    "ES": ("ray_tpu_torch.algorithms.es.es", "ESConfig", "CartPole-v1"),
    "ARS": ("ray_tpu_torch.algorithms.es.es", "ARSConfig", "CartPole-v1"),
    "BanditLinUCB": ("ray_tpu_torch.algorithms.bandit.bandit", "BanditLinUCBConfig", None),
    "BanditLinTS": ("ray_tpu_torch.algorithms.bandit.bandit", "BanditLinTSConfig", None),
}


@pytest.mark.parametrize("name", sorted(_SINGLE_AGENT))
def test_single_agent_algorithm_without_device_raises_without_cuda(monkeypatch, name):
    import importlib

    module, cfg_name, env = _SINGLE_AGENT[name]
    mod = importlib.import_module(module)
    if env is None:
        from ray_tpu_torch.algorithms.bandit.bandit import LinearContextBandit as env
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="none is available"):
        getattr(mod, cfg_name)().environment(env).build()


def test_multi_agent_and_slate_algorithms_run_with_reference_and_gymnasium_blocked():
    """MADDPG, QMIX (its device episode ring on CPU tensors) and SlateQ
    (DQN's rings) train until they learn, with the reference and
    gymnasium blocked."""
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
        import chip_smoke
        from ray_tpu_torch.algorithms.maddpg.maddpg import MADDPGConfig
        from ray_tpu_torch.algorithms.qmix.qmix import QMIXConfig
        from ray_tpu_torch.algorithms.slateq.slateq import SlateQConfig

        chip_smoke.register_coop_envs()
        cfgs = [
            MADDPGConfig().environment("coop_spread").training(
                actor_hiddens=[8], critic_hiddens=[8], train_batch_size=8,
                num_steps_sampled_before_learning_starts=16),
            QMIXConfig().environment("two_step_coop").training(
                train_batch_size=4, num_steps_sampled_before_learning_starts=16,
                episode_limit=4, agent_hiddens=[8], agent_cell_size=8),
            SlateQConfig().environment("SyntheticSlate-v0").training(
                train_batch_size=8, num_steps_sampled_before_learning_starts=20, hiddens=[8]),
        ]
        for cfg in cfgs:
            algo = cfg.debugging(seed=0).resources(device="cpu").build()
            for _ in range(4):
                r = algo.train()
            assert r["info"]["learner"]["default_policy"], type(algo).__name__
            algo.stop()
        bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
        assert not bad, bad
        print("ok")
        """
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stdout + proc.stderr


_MULTI_AGENT = {
    "MADDPG": ("ray_tpu_torch.algorithms.maddpg.maddpg", "MADDPGConfig", "CoopSpreadEnv"),
    "QMIX": ("ray_tpu_torch.algorithms.qmix.qmix", "QMIXConfig", "TwoStepCoopEnv"),
    "SlateQ": ("ray_tpu_torch.algorithms.slateq.slateq", "SlateQConfig", None),
}


@pytest.mark.parametrize("name", sorted(_MULTI_AGENT))
def test_multi_agent_algorithm_without_device_raises_without_cuda(monkeypatch, name):
    import importlib

    import test_bandit_qmix

    module, cfg_name, env = _MULTI_AGENT[name]
    mod = importlib.import_module(module)
    env = getattr(test_bandit_qmix, env) if env else "SyntheticSlate-v0"
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="none is available"):
        getattr(mod, cfg_name)().environment(env).build()
