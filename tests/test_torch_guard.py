"""Guards of the PyTorch port: it imports neither JAX nor the JAX package,
and its Env runs on CUDA unless the caller asks for the CPU."""

import ast
import os

import pytest
import torch

import madrona_mp_env_tpu_torch as mt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "madrona_mp_env_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "madrona_mp_env_tpu")


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PKG):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return files


def _imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


TRAIN_MODULES = ("__init__", "convert", "distributions", "elo", "infer",
                 "metrics", "models", "normalizer", "pbt", "policy", "ppo",
                 "train", "trainer")


def test_port_imports_no_jax():
    files = _port_files()
    assert len(files) > 30
    train = {os.path.relpath(p, PKG) for p in files if "train" in p}
    assert train == {f"train/{m}.py" for m in TRAIN_MODULES}
    assert os.path.join(PKG, "ops", "tail_fused.py") in files
    assert os.path.join(PKG, "ops", "culling.py") in files
    for path in files:
        for name in _imported_roots(path):
            root = name.split(".")[0]
            assert root not in FORBIDDEN, f"{path} imports {name}"


def test_env_defaults_to_cuda_and_raises_without_it(monkeypatch,
                                                    simple_map_dir):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = mt.EnvConfig(task=mt.Task.Zone, team_size=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        mt.Env(cfg, simple_map_dir, num_worlds=2)
    env = mt.Env(cfg, simple_map_dir, num_worlds=2, device="cpu")
    assert env.device.type == "cpu"


def test_kernel_entries_refuse_other_devices():
    """A kernel entry takes a CPU tensor to its plain version and a CUDA
    tensor to its kernel; any other device raises."""
    from madrona_mp_env_tpu_torch.ops import raycast

    with pytest.raises(ValueError, match="device"):
        raycast._route(torch.zeros(3, device="meta"))
    assert raycast._route(torch.zeros(3)) is False


def test_unported_config_raises(simple_map_dir):
    cfg = mt.EnvConfig(task=mt.Task.TDM, team_size=2)
    with pytest.raises(NotImplementedError):
        mt.Env(cfg, simple_map_dir, num_worlds=1, device="cpu")


def test_train_cli_defaults_to_cuda(monkeypatch, simple_map_dir):
    """The train CLI runs on the card unless --cpu asks for the CPU."""
    from madrona_mp_env_tpu_torch.train import train as train_cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = ["--num-worlds", "1", "--team-size", "2", "--scene",
            simple_map_dir]
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.build(train_cli.parse_args(args))
    _, _, env, mgr = train_cli.build(train_cli.parse_args(args + ["--cpu"]))
    assert env.device.type == mgr.device.type == "cpu"
