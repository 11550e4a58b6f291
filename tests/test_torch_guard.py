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


DATA_MODULES = ("__init__", "build_db", "build_trajectory_curriculum",
                "export", "formats", "recorder", "select_trajectories",
                "trajectory_db")
TRAIN_MODULES = ("__init__", "bc", "convert", "distributions", "elo",
                 "full_team_policy", "hash_encoder", "infer", "metrics",
                 "models", "normalizer", "pbt", "policy", "ppo", "train",
                 "trainer")
TOOLS = ("fan_probe", "vpu_probe", "golden", "tokenize_steps", "ngrams",
         "print_assignments", "build_trajectory_training_dataset",
         "scaling_bench", "build_culling", "make_town_map", "convert_assets",
         "viz_server", "viewer", "convert_weights")
PARALLEL_MODULES = ("__init__", "collectives", "distributed", "sharding")


def test_port_imports_no_jax():
    files = _port_files()
    assert len(files) > 30
    train = {os.path.relpath(p, PKG) for p in files
             if os.sep + "train" + os.sep in p}
    assert train == {f"train/{m}.py" for m in TRAIN_MODULES}
    assert os.path.join(PKG, "ops", "tail_fused.py") in files
    assert os.path.join(PKG, "ops", "culling.py") in files
    for probe in ("movement_fused_probe", "v9_kernel_probe",
                  "v9_scan_timing", "sc_mxu_probe"):
        assert os.path.join(PKG, "tools", "probes", f"{probe}.py") in files
    assert os.path.join(PKG, "sim", "bot.py") in files
    assert os.path.join(PKG, "assets", "nav_build.py") in files
    assert os.path.join(PKG, "sim", "replay.py") in files
    data = {os.path.relpath(p, PKG) for p in files
            if os.sep + "data" + os.sep in p}
    assert data == {f"data/{m}.py" for m in DATA_MODULES}
    for tool in TOOLS:
        assert os.path.join(PKG, "tools", f"{tool}.py") in files
    assert os.path.join(PKG, "utils", "xla_math.py") in files
    parallel = {os.path.relpath(p, PKG) for p in files
                if os.sep + "parallel" + os.sep in p}
    assert parallel == {f"parallel/{m}.py" for m in PARALLEL_MODULES}
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


def test_parallel_entry_points_default_to_cuda(monkeypatch):
    """The train CLI's --num-devices and the scaling bench run on the card
    unless asked for the CPU: without one they raise before any rank
    starts."""
    from madrona_mp_env_tpu_torch.tools import scaling_bench
    from madrona_mp_env_tpu_torch.train import train as train_cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="visible"):
        train_cli.main(["--num-devices", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        scaling_bench.main([])


def test_table_builders_default_to_cuda(monkeypatch, simple_map_dir,
                                       tmp_path):
    """tools/build_culling.py and load_map(build_culling=True) build the
    culling tables on the card unless asked for the CPU: without one they
    raise before any battery runs."""
    import shutil

    from madrona_mp_env_tpu_torch.assets.map_data import load_map
    from madrona_mp_env_tpu_torch.ops import culling
    from madrona_mp_env_tpu_torch.tools import build_culling

    scene = str(tmp_path / "simple_map")
    shutil.copytree(simple_map_dir, scene)
    os.remove(os.path.join(scene, "culling_ray.npz"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_culling.main([scene])
    with pytest.raises(RuntimeError, match="CUDA"):
        load_map(scene, mt.EnvConfig(team_size=2), build_culling=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        culling.builder_device("cuda")
    assert culling.builder_device("cpu").type == "cpu"
    m = load_map(scene, mt.EnvConfig(team_size=2), device="cpu")
    assert m.cells is None and m.ray_cells is None
    assert sorted(os.listdir(scene)) == sorted(
        n for n in os.listdir(simple_map_dir) if n != "culling_ray.npz")


def test_kernel_entries_refuse_other_devices():
    """A kernel entry takes a CPU tensor to its plain version and a CUDA
    tensor to its kernel; any other device raises."""
    from madrona_mp_env_tpu_torch.ops import raycast

    with pytest.raises(ValueError, match="device"):
        raycast._route(torch.zeros(3, device="meta"))
    assert raycast._route(torch.zeros(3)) is False


def test_unported_config_raises(simple_map_dir):
    """FullTeamPolicy, EnableCurriculum, StaticFlipTeams, the spawn
    curriculum, a non-default trajectory_curriculum_prob and the logging
    step construct and step on the CPU (the curriculum file's restore:
    tests/test_torch_data.py); the full-team interface without two teams
    raises."""
    for cfg, kw in (
        (mt.EnvConfig(team_size=2, sim_flags=mt.SimFlags.FullTeamPolicy), {}),
        (mt.EnvConfig(team_size=2, sim_flags=mt.SimFlags.EnableCurriculum),
         {}),
        (mt.EnvConfig(team_size=2, sim_flags=mt.SimFlags.StaticFlipTeams),
         {}),
        (mt.EnvConfig(team_size=2, enable_spawn_curriculum=True), {}),
        (mt.EnvConfig(team_size=2, trajectory_curriculum_prob=1.0),
         dict(collect_log=True)),
    ):
        env = mt.Env(cfg, simple_map_dir, num_worlds=1, device="cpu", **kw)
        state, _ = env.reset()
        _, out = env.step(state, env.zero_actions())
        assert bool(torch.isfinite(out["reward"]).all())
    with pytest.raises(ValueError, match="two full teams"):
        mt.Env(mt.EnvConfig(task=mt.Task.Explore,
                            sim_flags=mt.SimFlags.FullTeamPolicy),
               simple_map_dir, num_worlds=1, device="cpu")


def test_shared_map_checked(simple_map_dir):
    """Env(map_data=...) shares a map loaded for a configuration of the
    same map_key (another task and flags that load_map does not read), and
    raises on a map loaded for other map inputs."""
    from madrona_mp_env_tpu_torch.assets.map_data import load_map

    m = load_map(simple_map_dir, mt.EnvConfig(team_size=2), device="cpu")
    cfg = mt.EnvConfig(task=mt.Task.TDM, team_size=3,
                       sim_flags=mt.SimFlags.EnableCurriculum)
    env = mt.Env(cfg, simple_map_dir, num_worlds=1, device="cpu",
                 map_data=m)
    assert env.map_data is m
    for other in (mt.EnvConfig(team_size=2, enable_spawn_curriculum=True),
                  mt.EnvConfig(team_size=2,
                               sim_flags=mt.SimFlags.SpawnInMiddle)):
        with pytest.raises(ValueError, match="map_data"):
            mt.Env(other, simple_map_dir, num_worlds=1, device="cpu",
                   map_data=m)


def test_full_team_policy_defaults_to_cuda(monkeypatch):
    """build_full_team_policy puts the net on the card unless asked for
    the CPU."""
    from madrona_mp_env_tpu_torch.train import build_full_team_policy

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_full_team_policy(2)
    net = build_full_team_policy(2, device="cpu")
    assert next(net.parameters()).device.type == "cpu"


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


def test_bc_cli_defaults_to_cuda(monkeypatch, tmp_path):
    """train/bc.py (the CLI and load_bc_data) runs on the card unless
    --cpu / device="cpu" asks for the CPU."""
    from madrona_mp_env_tpu_torch.train import bc

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = ["--ckpt-dir", str(tmp_path), "--in-run-name", "a",
            "--out-run-name", "b", "--start-update", "0", "--bc-data-dir",
            str(tmp_path)]
    with pytest.raises(RuntimeError, match="CUDA"):
        bc.main(args)
    with pytest.raises(RuntimeError, match="CUDA"):
        bc.load_bc_data(str(tmp_path))
    with pytest.raises(FileNotFoundError):  # past the device, to the files
        bc.main(args + ["--cpu"])


@pytest.mark.parametrize("cli", ["golden", "infer"])
def test_golden_and_eval_cli_default_to_cuda(monkeypatch, cli):
    """tools/golden.py and the eval CLI (train/infer.py) run on the card
    unless --cpu asks for the CPU."""
    from madrona_mp_env_tpu_torch.tools import golden
    from madrona_mp_env_tpu_torch.train import infer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        if cli == "golden":
            golden.main([])
        else:
            infer.main(["--num-worlds", "2", "--vs-bot", "--ckpt-path",
                        "policy.npz"])


def test_viz_server_defaults_to_cuda(monkeypatch, simple_map_dir):
    """tools/viz_server.py's live session (LiveSession, ViewerData(live=
    True)) and its CLI run on the card unless asked for the CPU: without
    one they raise before the server listens."""
    from madrona_mp_env_tpu_torch.tools import viz_server

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        viz_server.LiveSession(simple_map_dir, team_size=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        viz_server.ViewerData(simple_map_dir, live=True, team_size=2)
    for args in ([], ["--live"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            viz_server.main(["--scene", simple_map_dir] + args)
    live = viz_server.LiveSession(simple_map_dir, team_size=2, device="cpu")
    assert live.env.device.type == "cpu"


def test_kernel_bench_defaults_to_cuda(monkeypatch):
    """tools/kernel_bench.py runs on the card unless --device cpu."""
    from madrona_mp_env_tpu_torch.tools import kernel_bench

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        kernel_bench.main(["--worlds", "1"])


@pytest.mark.parametrize("probe", ["tools.probes.movement_fused_probe",
                                   "tools.probes.v9_kernel_probe",
                                   "tools.probes.v9_scan_timing",
                                   "tools.fan_probe",
                                   "tools.probes.sc_mxu_probe",
                                   "tools.vpu_probe"])
def test_probes_default_to_cuda(monkeypatch, probe):
    """Each probe runs on the card unless --device cpu."""
    import importlib

    mod = importlib.import_module(f"madrona_mp_env_tpu_torch.{probe}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main([])
