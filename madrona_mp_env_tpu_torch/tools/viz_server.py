"""Interactive viewer / analytics browser (the JAX package's
tools/viz_server.py).

Re-design of the reference's interactive viz app (src/viz.cpp: live sim +
replay browsing + heatmaps + the analytics DB browser at
viz.cpp:1229-1348 with its background query thread, viz.cpp:1212-1227).
Instead of a Vulkan/ImGui desktop app, the viewer is an HTTP server +
single-page canvas frontend (tools/viewer_web.html, the JAX package's
page byte for byte; the same routes, status codes and JSON): the sim
steps on the card (or the CPU), the browser renders.

Capabilities (mirroring viewer.cpp:22-34 init modes):
  * replay browsing — scrub any world/step of a record log
    (`--record`), with per-step events from an event-log dir or DB
  * analytics DB browser — canned match/step/event queries + free-form
    read-only SQL against the build_db SQLite schema, executed on a
    background query thread with a result mailbox (viz.cpp:1212-1227)
  * live sim — step a real Env server-side (every agent the scripted A*
    bot) and stream frames; on the card unless ``--cpu``
  * map/zone/spawn geometry and team trajectory heatmap data

Usage:
    python -m madrona_mp_env_tpu_torch.tools.viz_server \\
        --scene data/simple_map [--record out.bin --num-worlds 4] \\
        [--db events.db] [--event-log events/] [--live] [--port 8080] \\
        [--cpu]

The live session's Env runs on the first CUDA device and raises without
one; ``--cpu`` runs it on the CPU (the plain versions of the kernels).
The server builds the kernels before it listens, and the session builds
the bot's next-hop table when it starts, so no request pays for either.
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import sqlite3
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

import torch

from ..assets.formats import load_collision_data, load_navmesh, load_zones
from ..config import EnvConfig, Task
from ..data.recorder import host_arrays
from ..sim.env import Env, resolve_device


def _tolist(x):
    return np.asarray(x).tolist()


# ---------------------------------------------------------------------------
# Background analytics query thread (viz.cpp:1212-1227: queries run off the
# render thread through an atomic command mailbox; here a worker thread +
# ticketed result mailbox).
# ---------------------------------------------------------------------------

CANNED_QUERIES = {
    # viz.cpp:1229-1348 prepared statements, by intent
    "matches": "SELECT id, orig_id, num_steps FROM matches ORDER BY id",
    "match_steps": (
        "SELECT id, step_idx, cur_zone, cur_zone_controller, num_events "
        "FROM match_steps WHERE match_id = :match_id ORDER BY step_idx"
    ),
    "players_at_step": (
        "SELECT player_idx, pos_x, pos_y, pos_z, yaw, hp, num_bullets, "
        "fired_shot FROM player_states WHERE step_id = :step_id "
        "ORDER BY player_idx"
    ),
    "kills_in_match": (
        "SELECT k.id, s.step_idx, pk.player_idx AS killer, "
        "pd.player_idx AS killed, pd.pos_x, pd.pos_y FROM kill_events k "
        "JOIN match_steps s ON k.step_id = s.id "
        "JOIN player_states pk ON k.killer_id = pk.id "
        "JOIN player_states pd ON k.killed_id = pd.id "
        "WHERE s.match_id = :match_id ORDER BY s.step_idx"
    ),
    "kills_near": (
        "SELECT s.match_id, s.step_idx, pd.pos_x, pd.pos_y "
        "FROM kill_events k "
        "JOIN match_steps s ON k.step_id = s.id "
        "JOIN player_states pd ON k.killed_id = pd.id "
        "WHERE (pd.pos_x - :x) * (pd.pos_x - :x) + "
        "(pd.pos_y - :y) * (pd.pos_y - :y) <= :r * :r"
    ),
    "captures_in_match": (
        "SELECT s.step_idx, c.zone_idx, c.capture_team_idx, c.num_in_zone "
        "FROM capture_events c JOIN match_steps s ON c.step_id = s.id "
        "WHERE s.match_id = :match_id ORDER BY s.step_idx"
    ),
    "team_positions": (
        "SELECT p.pos_x, p.pos_y, p.player_idx FROM player_states p "
        "JOIN match_steps s ON p.step_id = s.id "
        "WHERE s.match_id = :match_id"
    ),
}


class QueryWorker:
    """Single background thread executing read-only SQLite queries; results
    land in a ticketed mailbox the HTTP handlers poll."""

    def __init__(self, db_path: str):
        self.db_path = db_path
        self._q: "queue.Queue" = queue.Queue()
        self._results: Dict[int, Dict[str, Any]] = {}
        self._lock = threading.Lock()
        self._next_ticket = 0
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def submit(self, sql: str, params: Dict[str, Any]) -> int:
        with self._lock:
            ticket = self._next_ticket
            self._next_ticket += 1
            self._results[ticket] = {"status": "pending"}
        self._q.put((ticket, sql, params))
        return ticket

    def result(self, ticket: int) -> Dict[str, Any]:
        with self._lock:
            return self._results.get(ticket, {"status": "unknown"})

    def _run(self):
        # one connection on the worker thread; read-only so the viewer can
        # never corrupt an analytics DB that training is still appending to
        conn = sqlite3.connect(
            f"file:{self.db_path}?mode=ro", uri=True, check_same_thread=False
        )
        conn.execute("PRAGMA query_only = ON")
        while True:
            ticket, sql, params = self._q.get()
            try:
                cur = conn.execute(sql, params)
                cols = [d[0] for d in cur.description] if cur.description else []
                rows = cur.fetchmany(100000)
                out = {
                    "status": "done",
                    "columns": cols,
                    "rows": [
                        [
                            v if not isinstance(v, bytes) else v.hex()
                            for v in row
                        ]
                        for row in rows
                    ],
                }
            except sqlite3.Error as e:
                out = {"status": "error", "error": str(e)}
            with self._lock:
                self._results[ticket] = out


# ---------------------------------------------------------------------------
# Live sim session (viewer.cpp live mode): a real Env stepped server-side.
# ---------------------------------------------------------------------------


class LiveSession:
    """One world of ``task`` at ``team_size`` on ``device`` (None: the
    first CUDA device, raising without one), every agent the scripted A*
    bot; ``step`` advances it under a lock, since the server's handler
    threads share it. As in the JAX package, ``reset`` ignores its
    ``seed``: the Env's seed is the one given here."""

    def __init__(self, scene: str, team_size: int = 3, seed: int = 0,
                 task: str = "Zone", device=None):
        self.cfg = EnvConfig(task=getattr(Task, task), team_size=team_size)
        self.env = Env(self.cfg, scene, num_worlds=1, seed=seed,
                       device=resolve_device(device))
        self._sc = self.env.default_sim_ctrl()
        self._nr = torch.zeros((1,), dtype=torch.int32,
                               device=self.env.device)
        self._lock = threading.Lock()
        # the bot's next-hop table (seconds on town_map): built here, not
        # inside the first request
        self.env.map_data.nav_next_hop()
        self.reset(seed)

    def reset(self, seed: Optional[int] = None):
        state, _ = self.env.reset()
        # all agents scripted A* bots
        with self._lock:
            self.state = state.replace(
                policy_idx=torch.full_like(state.policy_idx, -1))

    def step(self, n: int = 1) -> Dict[str, Any]:
        with self._lock:
            for _ in range(max(1, min(n, 100))):
                self.state, _ = self.env.step(
                    self.state, self.env.zero_actions(), self._sc, self._nr
                )
            s = self.state
            # one copy to the host for the whole frame
            h = host_arrays({
                "step": s.cur_step[0], "pos": s.pos[0], "yaw": s.yaw[0],
                "hp": s.hp[0], "cur_zone": s.zone_cur[0],
                "controller": s.zone_controlling[0],
                "team_points": s.team_points[0],
            })
        return {
            "step": int(h["step"]),
            "pos": _tolist(h["pos"]),
            "yaw": _tolist(h["yaw"]),
            "hp": _tolist(h["hp"]),
            "alive": _tolist(h["hp"] > 0),
            "cur_zone": int(h["cur_zone"]),
            "controller": int(h["controller"]),
            "team_points": _tolist(h["team_points"]),
        }


# ---------------------------------------------------------------------------
# Data sources
# ---------------------------------------------------------------------------


class ViewerData:
    def __init__(
        self,
        scene: str,
        record: Optional[str] = None,
        num_worlds: int = 0,
        event_log: Optional[str] = None,
        db: Optional[str] = None,
        live: bool = False,
        team_size: int = 3,
        device=None,
    ):
        """``device``: the live session's (None: the first CUDA device,
        raising without one)."""
        self.scene = scene
        self.team_size = team_size
        self.map_json = self._load_map(scene)
        self.reader = None
        if record is not None:
            from ..data.recorder import ReplayLogReader

            assert num_worlds > 0, "--num-worlds required with --record"
            self.reader = ReplayLogReader(record, num_worlds)
            self.num_worlds = num_worlds
        self.events = None
        if event_log is not None:
            from ..data.recorder import read_event_log, read_step_snapshots

            self.events = read_event_log(event_log)
            self.snapshots = read_step_snapshots(event_log)
        self.query_worker = QueryWorker(db) if db is not None else None
        self.live = (
            LiveSession(scene, team_size=team_size, device=device)
            if live else None
        )

    @staticmethod
    def _load_map(scene: str) -> Dict[str, Any]:
        col = load_collision_data(os.path.join(scene, "collisions.bin"))
        nav = load_navmesh(os.path.join(scene, "navmesh.bin"))
        zones = load_zones(os.path.join(scene, "zones.bin"))
        return {
            "bounds_min": _tolist(col.world_bounds_min),
            "bounds_max": _tolist(col.world_bounds_max),
            "collision_tris": _tolist(col.tri_verts),
            "nav_verts": _tolist(nav.verts),
            "nav_tris": _tolist(nav.tri_indices.astype(np.int64)),
            "zones": {
                "min": _tolist(zones.aabb_min),
                "max": _tolist(zones.aabb_max),
                "rotation": _tolist(zones.rotations),
            },
        }

    # ---- replay
    def replay_meta(self) -> Dict[str, Any]:
        if self.reader is None:
            return {"available": False}
        return {
            "available": True,
            "num_steps": len(self.reader),
            "num_worlds": self.num_worlds,
        }

    def replay_frame(self, step: int, world: int) -> Dict[str, Any]:
        # StepLog carries the reference's fixed 12 agent slots
        # (mgr.cpp:493-505); present only the configured 2*team_size
        log = self.reader.step(step)
        A = 2 * self.team_size
        log = {
            k: (v[:, :A] if v.ndim > 1 and v.shape[1] == 12 else v)
            for k, v in log.items()
        }
        hp = log["hp"][world]
        return {
            "step": int(log["cur_step"][world]),
            "pos": _tolist(log["pos"][world]),
            "yaw": _tolist(log["aim_yaw"][world]),
            "hp": _tolist(hp),
            "alive": _tolist(hp > 0),
            "fired": _tolist(log["fired_shot_t"][world] >= 0),
            "shot_agent_idx": _tolist(log["shot_agent_idx"][world]),
            "was_killed": _tolist(log["was_killed"][world]),
            "mag_bullets": _tolist(log["mag_bullets"][world]),
        }

    def event_list(self, world: int) -> Dict[str, Any]:
        if self.events is None:
            return {"available": False, "events": []}
        ev = self.events
        worlds = (ev["match_id"] >> 32).astype(np.int64)
        sel = ev[worlds == world]
        return {
            "available": True,
            "events": [
                {
                    "type": int(e["type"]),
                    "step": int(e["step"]),
                    "match_id": int(e["match_id"] & 0xFFFFFFFF),
                }
                for e in sel
            ],
        }


# ---------------------------------------------------------------------------
# HTTP plumbing
# ---------------------------------------------------------------------------


def make_handler(data: ViewerData):
    html_path = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "viewer_web.html"
    )

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _json(self, obj, code: int = 200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            u = urlparse(self.path)
            q = {k: v[0] for k, v in parse_qs(u.query).items()}
            try:
                if u.path == "/":
                    with open(html_path, "rb") as f:
                        body = f.read()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif u.path == "/api/map":
                    self._json(data.map_json)
                elif u.path == "/api/replay/meta":
                    self._json(data.replay_meta())
                elif u.path == "/api/replay/frame":
                    self._json(
                        data.replay_frame(
                            int(q.get("step", 0)), int(q.get("world", 0))
                        )
                    )
                elif u.path == "/api/events":
                    self._json(data.event_list(int(q.get("world", 0))))
                elif u.path == "/api/db/canned":
                    self._json({"queries": sorted(CANNED_QUERIES)})
                elif u.path == "/api/db/result":
                    if data.query_worker is None:
                        self._json({"status": "no-db"}, 400)
                    else:
                        self._json(
                            data.query_worker.result(int(q["ticket"]))
                        )
                elif u.path == "/api/live/step":
                    if data.live is None:
                        self._json({"error": "live mode off"}, 400)
                    else:
                        self._json(data.live.step(int(q.get("n", 1))))
                elif u.path == "/api/live/reset":
                    if data.live is None:
                        self._json({"error": "live mode off"}, 400)
                    else:
                        data.live.reset()
                        self._json({"ok": True})
                else:
                    self._json({"error": "not found"}, 404)
            except (ValueError, KeyError, IndexError, OSError) as e:
                self._json({"error": str(e)}, 400)

        def do_POST(self):
            u = urlparse(self.path)
            if u.path != "/api/db/submit":
                self._json({"error": "not found"}, 404)
                return
            if data.query_worker is None:
                self._json({"status": "no-db"}, 400)
                return
            n = int(self.headers.get("Content-Length", 0))
            try:
                req = json.loads(self.rfile.read(n) or b"{}")
                if "canned" in req:
                    sql = CANNED_QUERIES[req["canned"]]
                else:
                    sql = req["sql"]
                ticket = data.query_worker.submit(
                    sql, req.get("params", {})
                )
                self._json({"ticket": ticket})
            except (ValueError, KeyError) as e:
                self._json({"error": str(e)}, 400)

    return Handler


def serve(data: ViewerData, port: int = 8080):
    httpd = ThreadingHTTPServer(("127.0.0.1", port), make_handler(data))
    return httpd


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", type=str, required=True)
    ap.add_argument("--record", type=str, default=None)
    ap.add_argument("--num-worlds", type=int, default=0)
    ap.add_argument("--event-log", type=str, default=None)
    ap.add_argument("--db", type=str, default=None)
    ap.add_argument("--live", action="store_true")
    ap.add_argument("--team-size", type=int, default=3)
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    device = resolve_device("cpu" if args.cpu else None)
    if device.type == "cuda":
        from ..ops import cuda_build

        cuda_build.build_all()
    data = ViewerData(
        scene=args.scene,
        record=args.record,
        num_worlds=args.num_worlds,
        event_log=args.event_log,
        db=args.db,
        live=args.live,
        team_size=args.team_size,
        device=device,
    )
    httpd = serve(data, args.port)
    print(f"viewer at http://127.0.0.1:{args.port}/", flush=True)
    httpd.serve_forever()


if __name__ == "__main__":
    main()
