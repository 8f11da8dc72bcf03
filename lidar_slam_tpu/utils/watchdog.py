"""Failure containment for long on-device runs: stall watchdog + retry +
checkpoint-resume.

A dispatch that hangs inside the device runtime cannot be interrupted from
inside the process — Python signal handlers only run between bytecodes, and
the stuck thread is inside the PJRT C++ runtime — so containment requires a
process boundary (the reference has no recovery story at all; its closest
analog is the NULL-file check in ``Subsystem_1/main.c:15-20`` that silently
returns):

- the WORKER runs the actual computation, emits a heartbeat after every
  chunk of work, and checkpoints its state (utils/checkpoint, atomic
  save) so progress survives a kill;
- the SUPERVISOR (this module) watches the heartbeat file's freshness and
  the worker's liveness from a separate process, kills the worker's whole
  process group when the heartbeat goes stale, and restarts it up to
  ``max_restarts`` times — each restart resumes from the last checkpoint.

The supervisor never touches the device: a JAX process reserves most of a
GPU's memory when it first uses it, so only the worker may. The CLI's
``--supervised`` flag wraps the particle-filter host loop with it.
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import os
import signal
import tempfile
import time


HEARTBEAT_FILE = "heartbeat"


def _worker_entry(worker, run_dir: str, args: tuple) -> None:
    """Subprocess entry: detach into an own session/process group first, so
    the supervisor's SIGKILL can take down helper subprocesses the worker
    spawns (``os.killpg``), not just the worker pid."""
    try:
        os.setsid()
    except OSError:
        pass   # already a session leader (unlikely, but harmless)
    worker(run_dir, *args)


def _kill_group(proc) -> None:
    """SIGKILL the worker's whole process group, falling back to the pid."""
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError, OSError):
        proc.kill()


class Heartbeat:
    """Worker-side liveness signal: ``beat()`` after every chunk of work.

    Atomic (write + rename) so the supervisor never reads a torn file; the
    payload is the last completed step for post-mortem logging, but staleness
    is judged by mtime alone."""

    def __init__(self, run_dir: str):
        os.makedirs(run_dir, exist_ok=True)
        self.path = os.path.join(run_dir, HEARTBEAT_FILE)

    def beat(self, step: int = -1) -> None:
        d = os.path.dirname(self.path)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".hb.tmp")
        try:
            with os.fdopen(fd, "w") as f:
                f.write(f"{step} {time.time():.3f}\n")
            os.replace(tmp, self.path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)


def heartbeat_age(run_dir: str) -> float:
    """Seconds since the worker's last beat (inf when it never beat)."""
    try:
        return time.time() - os.path.getmtime(
            os.path.join(run_dir, HEARTBEAT_FILE))
    except OSError:
        return float("inf")


@dataclasses.dataclass
class SuperviseReport:
    completed: bool          # worker finished with exit code 0
    attempts: int            # total worker launches (1 = no failure)
    stalls: int              # kills due to a stale heartbeat
    crashes: int             # nonzero worker exits
    seconds: float


def run_supervised(worker, args: tuple, run_dir: str, *,
                   stall_timeout_s: float, max_restarts: int = 1,
                   poll_s: float = 0.25,
                   deadline_s: float | None = None,
                   boot_grace_s: float | None = None) -> SuperviseReport:
    """Run ``worker(run_dir, *args)`` in a subprocess under a stall watchdog.

    ``worker`` must be a module-level (picklable) callable that:
    - creates ``Heartbeat(run_dir)`` and beats after every chunk of work;
    - checkpoints its state into ``run_dir`` (utils/checkpoint.save_state)
      often enough that a kill loses at most one chunk;
    - on start, resumes from its checkpoint when one exists.

    When the heartbeat goes stale for ``stall_timeout_s`` the worker's
    process group is SIGKILLed and relaunched (the checkpoint makes that a
    resume, not a rerun), up to ``max_restarts`` times. A worker that exits
    nonzero is also restarted. Returns a :class:`SuperviseReport`.

    Until an attempt's FIRST beat, staleness is judged against
    ``boot_grace_s`` (default ``max(stall_timeout_s, 30)``) instead of
    ``stall_timeout_s``: the wedged-dispatch failure this module contains
    only occurs after work has started, while a spawned child first pays
    for importing jax and initialising the device runtime (seconds) — a
    tight stall timeout must not misread that as a stall and kill every
    attempt at boot.
    """
    ctx = multiprocessing.get_context("spawn")
    if boot_grace_s is None:
        boot_grace_s = max(stall_timeout_s, 30.0)
    t0 = time.time()
    stalls = crashes = 0
    attempts = 0
    os.makedirs(run_dir, exist_ok=True)

    while attempts <= max_restarts:
        attempts += 1
        launch = time.time()
        proc = ctx.Process(target=_worker_entry,
                           args=(worker, run_dir, tuple(args)), daemon=True)
        proc.start()
        while True:
            if deadline_s is not None and time.time() - t0 > deadline_s:
                _kill_group(proc)
                proc.join(5.0)
                return SuperviseReport(False, attempts, stalls, crashes,
                                       time.time() - t0)
            proc.join(poll_s)
            if proc.exitcode is not None:
                break
            # this attempt hasn't beat until the heartbeat file is newer
            # than the launch; a stale file from a previous attempt (or
            # none at all) leaves the attempt in its boot-grace window
            booted = (time.time() - heartbeat_age(run_dir)) > launch
            age = min(heartbeat_age(run_dir), time.time() - launch)
            if age > (stall_timeout_s if booted else boot_grace_s):
                _kill_group(proc)
                proc.join(5.0)
                stalls += 1
                break
        if proc.exitcode == 0:
            return SuperviseReport(True, attempts, stalls, crashes,
                                   time.time() - t0)
        if proc.exitcode is not None and proc.exitcode != -9:
            crashes += 1
    return SuperviseReport(False, attempts, stalls, crashes,
                           time.time() - t0)


# ---------------------------------------------------------------------------
# A supervised, checkpoint-resumable particle-filter run (the CLI's
# --supervised path). Module-level so multiprocessing can spawn it.
# ---------------------------------------------------------------------------

CKPT_FILE = "state.npz"
PATH_FILE = "path.npy"


def pf_worker(run_dir: str, ranges, cfg, seed: int = 0,
              ckpt_every: int = 100) -> None:
    """Checkpointed particle-filter host loop (resumes when re-launched)."""
    import jax.numpy as jnp
    import numpy as np

    from lidar_slam_tpu.models import fastslam
    from lidar_slam_tpu.utils import checkpoint

    hb = Heartbeat(run_dir)
    ckpt = os.path.join(run_dir, CKPT_FILE)
    path_file = os.path.join(run_dir, PATH_FILE)
    step = fastslam.make_pf_step(cfg)
    state = fastslam.init_particles(jnp.asarray(ranges[0]), cfg, seed)
    start = 1
    poses = np.zeros((len(ranges), 3), np.float32)
    if os.path.exists(ckpt):
        state = checkpoint.load_state(ckpt, state)
        start = int(np.asarray(state.step)) + 1
        if os.path.exists(path_file):
            prev = np.load(path_file)
            poses[:min(len(prev), start)] = prev[:start]
    hb.beat(start - 1)
    for t in range(start, len(ranges)):
        state, pose = step(state, jnp.asarray(ranges[t]))
        poses[t] = np.asarray(pose)   # host fetch: the heartbeat is honest
        hb.beat(t)
        if t % ckpt_every == 0 or t == len(ranges) - 1:
            np.save(path_file, poses[:t + 1])
            checkpoint.save_state(ckpt, state)
    np.save(path_file, poses)
    checkpoint.save_state(ckpt, state)


RUN_ID_FILE = "run_id.txt"


def _run_identity(ranges, cfg, seed: int) -> str:
    """Content hash identifying one logical run (config + data + seed)."""
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    h.update(cfg.to_json().encode())
    h.update(f"seed={seed} n={len(ranges)}".encode())
    h.update(np.ascontiguousarray(ranges[0], np.float32).tobytes())
    return h.hexdigest()[:16]


def run_pf_supervised(ranges, cfg, run_dir: str, *, seed: int = 0,
                      stall_timeout_s: float = 120.0, max_restarts: int = 1,
                      ckpt_every: int = 100, resume: bool = False):
    """Particle-filter run that survives a wedged device: supervised worker
    + checkpoint-resume. Returns (path (T, 3), SuperviseReport).

    The run_dir is stamped with a run identity (hash of config + data +
    seed). Leftover state is cleared before launch unless ``resume=True``
    AND the stamp matches — a second run on different data in a shared
    run_dir must never silently resume (or skip to) another run's state
    (ADVICE r4: the CLI's shared '.slam_run' default made exactly that
    happen)."""
    import numpy as np

    run_id = _run_identity(ranges, cfg, seed)
    os.makedirs(run_dir, exist_ok=True)
    id_file = os.path.join(run_dir, RUN_ID_FILE)
    try:
        with open(id_file) as f:
            same_run = f.read().strip() == run_id
    except OSError:
        same_run = False
    if not (resume and same_run):
        for name in (CKPT_FILE, PATH_FILE, HEARTBEAT_FILE):
            p = os.path.join(run_dir, name)
            if os.path.exists(p):
                os.unlink(p)
    with open(id_file, "w") as f:
        f.write(run_id)

    report = run_supervised(pf_worker, (ranges, cfg, seed, ckpt_every),
                            run_dir, stall_timeout_s=stall_timeout_s,
                            max_restarts=max_restarts)
    path_file = os.path.join(run_dir, PATH_FILE)
    path = np.load(path_file) if os.path.exists(path_file) else None
    return path, report
