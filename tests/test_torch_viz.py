"""The port's viz server (tools/viz_server.py) against the JAX package's,
on the CPU.

The server runs in this process on an ephemeral port. Its record and
event log are the JAX logging run of fixtures_torch/zone_record.npz (Zone
2v2 on simple_map, 2 worlds, 12 steps), written through the port's
writers (byte-equal to the JAX package's: tests/test_torch_record.py),
its DB the port's build_db of that log. Held against the JAX package's
ViewerData and QueryWorker on the same files (numpy and sqlite, no jit):

- the page's bytes, the map JSON, the replay's meta and frames, the event
  lists, and every canned query's rows and a free-form query's (a write
  comes back as an error);
- an out-of-range frame, an unknown route and the live routes of a server
  without --live answer 400 / 404 as the JAX server does;
- the live session's frames (every agent the A* bot, 1 world, 2v2, the
  calls of fixtures_torch/make_viz_fixture.py) against the JAX
  LiveSession's (viz_live_jax.json): step, hp, alive, cur_zone,
  controller and team_points exact, pos and yaw within 1e-4 * max(1,
  |x|), the slice tests' bar.

Every HTTP call times out after TIMEOUT seconds.
"""

import json
import os
import socket
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from madrona_mp_env_tpu.tools import viz_server as jax_viz
from madrona_mp_env_tpu_torch.data import EventLogWriter, RecordLogWriter
from madrona_mp_env_tpu_torch.data.build_db import build_db
from madrona_mp_env_tpu_torch.tools import viz_server

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "fixtures_torch"))
import make_record_fixture as rx  # noqa: E402
import make_viz_fixture as vf  # noqa: E402
from torch_threads import one_thread_under_xdist  # noqa: E402,F401

TIMEOUT = 30
REL = 1e-4
TEAM_SIZE = 2
# each canned query with parameters that select rows of the fixture's DB
CANNED_PARAMS = {
    "matches": {},
    "match_steps": {"match_id": 1},
    "players_at_step": {"step_id": 3},
    "kills_in_match": {"match_id": 1},
    "kills_near": {"x": 0.0, "y": 0.0, "r": 5000.0},
    "captures_in_match": {"match_id": 1},
    "team_positions": {"match_id": 1},
}


def write_logs(out_dir):
    """The fixture's JAX logging run -> record.bin, events/ and
    analytics.db in ``out_dir`` through the port's writers and build_db;
    returns their paths."""
    with np.load(rx.PATH) as z:
        rec = {k[4:]: z[k] for k in z.files if k.startswith("rec/")}

    def step(group, s):
        n = len(group) + 1
        return {k[n:]: v[s] for k, v in rec.items()
                if k.startswith(group + "/")}

    record = os.path.join(out_dir, "record.bin")
    events = os.path.join(out_dir, "events")
    with RecordLogWriter(record) as rw, EventLogWriter(events) as ew:
        for s in range(rx.REC_STEPS):
            rw.append(step("step_log", s))
            ew.append(step("snapshot", s), step("game_events", s))
    db = os.path.join(out_dir, "analytics.db")
    build_db(events, db, team_size=TEAM_SIZE)
    return record, events, db


@pytest.fixture(scope="module")
def logs(tmp_path_factory):
    return write_logs(str(tmp_path_factory.mktemp("viz")))


def start(data):
    """Serve ``data`` on an ephemeral port in a daemon thread: (base URL,
    server)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    httpd = viz_server.serve(data, port)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{port}", httpd


@pytest.fixture(scope="module")
def server(logs, simple_map_dir):
    record, events, db = logs
    data = viz_server.ViewerData(
        scene=simple_map_dir, record=record, num_worlds=rx.REC_WORLDS,
        event_log=events, db=db, live=True, team_size=TEAM_SIZE,
        device="cpu")
    url, httpd = start(data)
    yield url
    httpd.shutdown()
    httpd.server_close()


@pytest.fixture(scope="module")
def jax_data(logs, simple_map_dir):
    record, events, _ = logs
    return jax_viz.ViewerData(
        scene=simple_map_dir, record=record, num_worlds=rx.REC_WORLDS,
        event_log=events, team_size=TEAM_SIZE)


def get(url):
    with urllib.request.urlopen(url, timeout=TIMEOUT) as r:
        return json.loads(r.read())


def post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        return json.loads(r.read())


def http_error(url):
    with pytest.raises(urllib.error.HTTPError) as e:
        get(url)
    return e.value.code, json.loads(e.value.read())


def as_json(obj):
    """``obj`` as the server's JSON gives it back."""
    return json.loads(json.dumps(obj))


def test_page_and_map_match_jax(server, simple_map_dir):
    with urllib.request.urlopen(server + "/", timeout=TIMEOUT) as r:
        page = r.read()
    with open(os.path.join(os.path.dirname(jax_viz.__file__),
                           "viewer_web.html"), "rb") as f:
        assert page == f.read()
    got = get(server + "/api/map")
    assert got == as_json(jax_viz.ViewerData._load_map(simple_map_dir))
    assert len(got["collision_tris"]) > 0 and len(got["zones"]["min"]) >= 1


def test_replay_matches_jax(server, jax_data):
    assert get(server + "/api/replay/meta") == jax_data.replay_meta() == {
        "available": True, "num_steps": rx.REC_STEPS,
        "num_worlds": rx.REC_WORLDS}
    for step in (0, 5, rx.REC_STEPS - 1):
        for world in range(rx.REC_WORLDS):
            got = get(server + f"/api/replay/frame?step={step}&world={world}")
            assert got == as_json(jax_data.replay_frame(step, world))
            assert len(got["pos"]) == 2 * TEAM_SIZE
    code, body = http_error(server + "/api/replay/frame?step=99&world=0")
    assert code == 400 and "error" in body


def test_events_match_jax(server, jax_data):
    n = 0
    for world in range(rx.REC_WORLDS):
        got = get(server + f"/api/events?world={world}")
        assert got == as_json(jax_data.event_list(world))
        n += len(got["events"])
    assert n > 0


def query(submit, fetch, body):
    """Submit ``body`` and poll its ticket until the worker answers."""
    ticket = submit(body)
    deadline = time.monotonic() + TIMEOUT
    res = fetch(ticket)
    while res["status"] == "pending":
        assert time.monotonic() < deadline, body
        time.sleep(0.01)
        res = fetch(ticket)
    return res


def jax_query(worker, body):
    sql = (jax_viz.CANNED_QUERIES[body["canned"]] if "canned" in body
           else body["sql"])
    return query(lambda b: worker.submit(sql, b.get("params", {})),
                 worker.result, body)


def port_query(server, body):
    return query(lambda b: post(server + "/api/db/submit", b)["ticket"],
                 lambda t: get(server + f"/api/db/result?ticket={t}"), body)


@pytest.fixture(scope="module")
def jax_worker(logs):
    return jax_viz.QueryWorker(logs[2])


@pytest.mark.parametrize("name", sorted(CANNED_PARAMS))
def test_canned_query_matches_jax(server, jax_worker, name):
    assert get(server + "/api/db/canned") == {
        "queries": sorted(jax_viz.CANNED_QUERIES)}
    assert viz_server.CANNED_QUERIES == jax_viz.CANNED_QUERIES
    body = {"canned": name, "params": CANNED_PARAMS[name]}
    got = port_query(server, body)
    assert got["status"] == "done"
    assert got == as_json(jax_query(jax_worker, body))


def test_free_query_matches_jax_and_writes_fail(server, jax_worker):
    body = {"sql": "SELECT COUNT(*) AS n, MAX(hp) FROM player_states"}
    got = port_query(server, body)
    assert got == as_json(jax_query(jax_worker, body))
    assert got["rows"][0][0] > 0
    for sql in ("DELETE FROM matches",
                "INSERT INTO matches (orig_id, num_steps) VALUES (1, 1)"):
        got = port_query(server, {"sql": sql})
        assert got["status"] == "error"
        assert got == jax_query(jax_worker, {"sql": sql})
    assert port_query(server, {"canned": "matches"})["rows"]  # untouched
    code, body = http_error(server + "/api/db/result?ticket=x")
    assert code == 400 and "error" in body


def close(got, want, key):
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert g.shape == w.shape, key
    err = np.abs(g - w) / np.maximum(1.0, np.abs(w))
    assert err.max() <= REL, (key, err.max())


def test_live_frames_match_jax(server):
    with open(vf.PATH) as f:
        want = json.load(f)
    assert (want["scene"], want["team_size"], want["seed"]) == (
        "simple_map", TEAM_SIZE, 0)
    frames = []
    for call, n in want["calls"]:
        if call == "step":
            frames.append(get(server + f"/api/live/step?n={n}"))
        else:
            assert get(server + "/api/live/reset") == {"ok": True}
    assert len(frames) == len(want["frames"])
    for got, w in zip(frames, want["frames"]):
        assert set(got) == set(w)
        for key in ("step", "hp", "alive", "cur_zone", "controller",
                    "team_points"):
            assert got[key] == w[key], key
        for key in ("pos", "yaw"):
            close(got[key], w[key], key)


def test_server_without_live_or_db(simple_map_dir):
    url, httpd = start(viz_server.ViewerData(scene=simple_map_dir))
    try:
        assert get(url + "/api/replay/meta") == {"available": False}
        assert get(url + "/api/events?world=0") == {"available": False,
                                                    "events": []}
        for route in ("/api/live/step", "/api/live/reset"):
            assert http_error(url + route) == (400,
                                               {"error": "live mode off"})
        assert http_error(url + "/api/db/result?ticket=0") == (
            400, {"status": "no-db"})
        assert http_error(url + "/nowhere") == (404, {"error": "not found"})
        with pytest.raises(urllib.error.HTTPError) as e:
            post(url + "/api/db/submit", {"canned": "matches"})
        assert e.value.code == 400
    finally:
        httpd.shutdown()
        httpd.server_close()
