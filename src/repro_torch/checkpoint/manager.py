"""Checkpoint manager: step registry, keep-N GC, auto-resume."""

from __future__ import annotations

import pathlib
import re
import shutil
import threading

from . import checkpointer

_STEP_RE = re.compile(r"^step_(\d+)$")


class CheckpointManager:
    def __init__(self, directory: str | pathlib.Path, keep_n: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_n = keep_n
        self._pending: list[threading.Thread] = []
        self._sweep_stale()

    def _sweep_stale(self) -> None:
        """Crash hygiene: a worker lost mid-save leaves a ``step_N.tmp``
        (or a renamed-but-uncommitted ``step_N``) behind — never
        restorable (restore trusts only COMMIT markers) but holding
        disk forever.  Swept on construction; callers are single-writer
        per directory (the supervised recovery path re-uses one manager
        instance, so this never races its own async saves)."""
        for p in self.dir.iterdir():
            if not p.is_dir():
                continue
            if p.name.endswith(".tmp"):
                shutil.rmtree(p, ignore_errors=True)
                continue
            m = _STEP_RE.match(p.name)
            if m and not checkpointer.is_committed(p):
                shutil.rmtree(p, ignore_errors=True)

    def _path(self, step: int) -> pathlib.Path:
        return self.dir / f"step_{step}"

    def path(self, step: int) -> pathlib.Path:
        """Directory of ``step``'s checkpoint (for out-of-band readers
        like the Supervisor's regrow prewarm, which stages the newest
        committed checkpoint without going through ``restore``)."""
        return self._path(step)

    def steps(self) -> list[int]:
        out = []
        for p in self.dir.iterdir():
            m = _STEP_RE.match(p.name)
            if m and checkpointer.is_committed(p):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def save(self, step: int, tree, extra: dict | None = None,
             blocking: bool = True) -> None:
        extra = dict(extra or {}, step=step)
        if blocking:
            checkpointer.save(self._path(step), tree, extra)
        else:
            self._pending.append(
                checkpointer.save_async(self._path(step), tree, extra))
        self._gc()

    def wait(self) -> None:
        for th in self._pending:
            th.join()
        self._pending.clear()

    def restore(self, like, step: int | None = None):
        """Restore a checkpoint into the structure of ``like``.

        With an explicit ``step`` the restore is literal — a CRC
        mismatch raises straight through.  With ``step=None`` the
        manager walks committed steps newest-first and *falls back*
        past any checkpoint that fails CRC validation (or whose files
        vanished under it), raising
        :class:`~.checkpointer.CheckpointCorruption` only when no
        intact checkpoint remains."""
        self.wait()
        if step is not None:
            tree = checkpointer.restore(self._path(step), like)
            return tree, checkpointer.read_extra(self._path(step))
        steps = self.steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        last_err: Exception | None = None
        for s in reversed(steps):
            try:
                tree = checkpointer.restore(self._path(s), like)
                return tree, checkpointer.read_extra(self._path(s))
            except (checkpointer.CheckpointCorruption,
                    OSError, KeyError) as e:
                last_err = e
        raise checkpointer.CheckpointCorruption(
            f"no intact checkpoint in {self.dir}: {last_err}")

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[:-self.keep_n] if self.keep_n else []:
            shutil.rmtree(self._path(s), ignore_errors=True)
