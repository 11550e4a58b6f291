"""Host-side record and event-log writers and readers.

The step exports [W, ...] tensors (data/export.py); these classes copy
them to the host and pack them into the byte-compatible binary formats
(data/formats.py), the replacement of the Manager's staging-buffer file
I/O (reference src/mgr.cpp:376-505), as the JAX package's
data/recorder.py does. A writer takes one step (``append``) or a chunk of
steps stacked on a leading axis (``append_chunk``, [T, W, ...]); either
way a group of tensors crosses to the host in one copy (``host_arrays``),
not one per field. Each writer counts the seconds it spent (``seconds``:
copy, pack and write), the bytes it wrote and the steps it took.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Iterator

import numpy as np
import torch

from .formats import (EventType, GAME_EVENT_DTYPE,
                      PACKED_STEP_SNAPSHOT_DTYPE, STEP_LOG_DTYPE,
                      make_match_id)

# numpy views of the tensors' bytes; bfloat16 has no numpy dtype and is
# carried as its raw uint16 bits
_NUMPY = {torch.bool: np.bool_, torch.uint8: np.uint8, torch.int8: np.int8,
          torch.int16: np.int16, torch.int32: np.int32, torch.int64: np.int64,
          torch.float16: np.float16, torch.bfloat16: np.uint16,
          torch.float32: np.float32, torch.float64: np.float64}


def host_arrays(tensors: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """{name: tensor} on any device -> {name: numpy array} through one
    copy: the tensors' bytes are concatenated on their device, copied to
    the host once and split there. Numpy inputs pass through."""
    if all(isinstance(v, np.ndarray) for v in tensors.values()):
        return dict(tensors)
    items = [(k, torch.as_tensor(v)) for k, v in tensors.items()]
    dev = items[0][1].device
    flat = [v.detach().to(dev).contiguous().reshape(-1).view(torch.uint8)
            for _, v in items]
    raw = torch.cat(flat).cpu().numpy()
    out, at = {}, 0
    for (k, v), f in zip(items, flat):
        n = f.numel()
        out[k] = raw[at:at + n].view(_NUMPY[v.dtype]).reshape(v.shape)
        at += n
    return out


def _rows(x: Dict[str, np.ndarray], lead: int) -> Dict[str, np.ndarray]:
    """Merge the ``lead`` leading axes of every array into one."""
    return {k: v.reshape((-1,) + v.shape[lead:]) for k, v in x.items()}


# ---------------------------------------------------------------- StepLog
def pack_step_logs(log: Dict[str, np.ndarray]) -> np.ndarray:
    """[N, 12, ...] step-log arrays -> StepLog[N] records."""
    out = np.zeros(log["pos"].shape[0], dtype=STEP_LOG_DTYPE)
    ad = out["agent_data"]
    for k in ("pos", "aim_yaw", "aim_pitch", "aim_rot", "hp", "mag_bullets",
              "mag_reloading", "stand_cur", "stand_tgt", "stand_transition",
              "shot_agent_idx", "fired_shot_t", "was_killed",
              "successful_kill"):
        ad[k] = log[k]
    out["cur_step"] = log["cur_step"]
    return out


def unpack_step_logs(records: np.ndarray) -> Dict[str, np.ndarray]:
    """StepLog[N] records -> the replay's arrays ([N, 12, ...], cur_step
    [N])."""
    ad = records["agent_data"]
    out = {k: ad[k].copy() for k in ad.dtype.names}
    out["cur_step"] = records["cur_step"].copy()
    return out


class _Writer:
    def __init__(self):
        self.seconds = 0.0
        self.bytes_written = 0
        self.steps = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class RecordLogWriter(_Writer):
    """Appends StepLog[num_worlds] per step (mgr.cpp:493-505)."""

    def __init__(self, path: str):
        super().__init__()
        self._f = open(path, "wb")

    def append(self, step_log) -> None:
        """One step's [W, ...] step log."""
        self.append_chunk({k: v[None] for k, v in step_log.items()})

    def append_chunk(self, step_logs) -> None:
        """T steps' step logs, [T, W, ...] each, in step order."""
        t0 = time.perf_counter()
        host = host_arrays(step_logs)
        recs = pack_step_logs(_rows(host, 2))
        recs.tofile(self._f)
        self.bytes_written += recs.nbytes
        self.steps += host["cur_step"].shape[0]
        self.seconds += time.perf_counter() - t0

    def close(self) -> None:
        self._f.close()


class ReplayLogReader:
    """A record file read back as per-step replay arrays (mgr.cpp:481-491
    read path)."""

    def __init__(self, path: str, num_worlds: int):
        self.records = np.fromfile(path, dtype=STEP_LOG_DTYPE)
        if len(self.records) % num_worlds:
            raise ValueError(f"record file has {len(self.records)} StepLogs, "
                             f"not a multiple of {num_worlds} worlds")
        self.num_worlds = num_worlds
        self.num_steps = len(self.records) // num_worlds

    def step(self, i: int) -> Dict[str, np.ndarray]:
        W = self.num_worlds
        return unpack_step_logs(self.records[i * W:(i + 1) * W])

    def tensors(self, device=None) -> Dict[str, torch.Tensor]:
        """Every step at once, [T, W, ...] tensors on ``device`` (one copy
        per field); index [t] for Env.replay_step."""
        arrs = unpack_step_logs(self.records)
        return {k: torch.as_tensor(v.reshape((self.num_steps,
                                              self.num_worlds) + v.shape[1:]),
                                   device=device)
                for k, v in arrs.items()}

    def __len__(self) -> int:
        return self.num_steps

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        for i in range(self.num_steps):
            yield self.step(i)


# ------------------------------------------------------------- Event log
def pack_snapshots(snap: Dict[str, np.ndarray]) -> np.ndarray:
    """[N, ...] snapshot arrays -> PackedStepSnapshot[N] records."""
    out = np.zeros(snap["match_step"].shape[0],
                   dtype=PACKED_STEP_SNAPSHOT_DTYPE)
    out["num_events"] = snap["num_events"]
    out["event_mask"] = snap["event_mask"]
    out["match_id"] = make_match_id(snap["world_idx"], snap["episode_idx"])
    ms = out["match_state"]
    ms["step"] = snap["match_step"].astype(np.uint16)
    ms["cur_zone"] = snap["cur_zone"].astype(np.uint8)
    ms["cur_zone_controller"] = snap["cur_zone_controller"].astype(np.int8)
    ms["zone_steps_remaining"] = snap["zone_steps_remaining"].astype(
        np.uint16)
    ms["steps_until_point"] = snap["steps_until_point"].astype(np.uint16)
    pl = out["players"]
    for dst, src in (("pos", "player_pos"), ("yaw", "player_yaw"),
                     ("pitch", "player_pitch"), ("mag_bullets", "player_mag"),
                     ("is_reloading", "player_reloading"),
                     ("hp", "player_hp"), ("flags", "player_flags")):
        pl[dst] = snap[src]
    return out


def pack_game_events(ev: Dict[str, np.ndarray]) -> np.ndarray:
    """One step's event flags ([W] / [W, A]) -> GameEvent records (the
    host side of the sim's atomic logEvent, sim.cpp:23-39), in the JAX
    package's order: captures, reloads, kills, player shots, each in
    world-then-agent order."""
    match_id = make_match_id(ev["world_idx"], ev["episode_idx"])
    step = ev["match_step"].astype(np.uint32)
    records = []

    def emit(world_mask, etype, a, b, c=None):
        idx = np.nonzero(world_mask)
        n = len(idx[0])
        if n == 0:
            return
        r = np.zeros(n, dtype=GAME_EVENT_DTYPE)
        r["type"] = etype
        r["match_id"] = match_id[idx[0]]
        r["step"] = step[idx[0]]
        r["a"] = np.asarray(a)[idx].astype(np.uint8)
        r["b"] = np.asarray(b)[idx].astype(np.uint8)
        if c is not None:
            r["c"] = np.asarray(c)[idx[0]].astype(np.uint16)
        records.append(r)

    W, A = ev["reload_event"].shape
    player_idx = np.broadcast_to(np.arange(A, dtype=np.uint8), (W, A))
    emit(ev["capture_event"].astype(bool), EventType.CAPTURE,
         ev["capture_zone"], np.maximum(ev["capture_team"], 0),
         ev["in_zone_mask"])
    emit(ev["reload_event"].astype(bool), EventType.RELOAD, player_idx,
         ev["reload_bullets"])
    emit(ev["kill_event"].astype(bool), EventType.KILL, player_idx,
         np.maximum(ev["shot_victim"], 0))
    emit(ev["shot_event"].astype(bool), EventType.PLAYER_SHOT, player_idx,
         np.maximum(ev["shot_victim"], 0))
    # np.concatenate would repack the padded dtype (dropping the union's
    # padding): fill one array instead
    out = np.zeros(sum(len(r) for r in records), dtype=GAME_EVENT_DTYPE)
    at = 0
    for r in records:
        out[at:at + len(r)] = r
        at += len(r)
    return out


class EventLogWriter(_Writer):
    """Writes events.bin and steps.bin into a directory (mgr.cpp:392-412,
    418-471; writeGameEvents mgr.cpp:104-117)."""

    def __init__(self, dir_path: str):
        super().__init__()
        os.makedirs(dir_path, exist_ok=True)
        self._events = open(os.path.join(dir_path, "events.bin"), "wb")
        self._steps = open(os.path.join(dir_path, "steps.bin"), "wb")

    def append(self, snapshot, game_events) -> None:
        """One step's [W, ...] snapshot and game events."""
        self.append_chunk({k: v[None] for k, v in snapshot.items()},
                          {k: v[None] for k, v in game_events.items()})

    def append_chunk(self, snapshots, game_events) -> None:
        """T steps', [T, W, ...] each, in step order."""
        t0 = time.perf_counter()
        host = host_arrays({**{"s/" + k: v for k, v in snapshots.items()},
                            **{"e/" + k: v for k, v in game_events.items()}})
        snap = {k[2:]: v for k, v in host.items() if k.startswith("s/")}
        ev = {k[2:]: v for k, v in host.items() if k.startswith("e/")}
        recs = pack_snapshots(_rows(snap, 2))
        recs.tofile(self._steps)
        self.bytes_written += recs.nbytes
        T = snap["match_step"].shape[0]
        for t in range(T):
            er = pack_game_events({k: v[t] for k, v in ev.items()})
            if len(er):
                er.tofile(self._events)
                self.bytes_written += er.nbytes
        self.steps += T
        self.seconds += time.perf_counter() - t0

    def close(self) -> None:
        self._events.close()
        self._steps.close()


def read_event_log(dir_path: str) -> np.ndarray:
    return np.fromfile(os.path.join(dir_path, "events.bin"),
                       dtype=GAME_EVENT_DTYPE)


def read_step_snapshots(dir_path: str) -> np.ndarray:
    return np.fromfile(os.path.join(dir_path, "steps.bin"),
                       dtype=PACKED_STEP_SNAPSHOT_DTYPE)
