"""Thread-local sqlite connection cache with one-time schema creation.

This package's copy of ``skypilot_tpu/utils/db_utils.py``: opening a
fresh connection and re-running CREATE TABLE per call is measurable on
hot paths, so connections are cached per (thread, resolved path). The
path re-resolves each call, so a process that repoints ``$HOME`` (or the
journal path env) gets a fresh database.
"""
import os
import sqlite3
import threading
from typing import Callable, Sequence

_local = threading.local()


class SqliteConn:
    """Factory for thread-local connections to one logical database.

    ``migrations`` are ALTER TABLE statements applied best-effort after
    the schema script: CREATE TABLE IF NOT EXISTS no-ops on pre-existing
    tables, so column additions must be replayed here ("duplicate column"
    errors are the already-migrated case and are swallowed).
    """

    def __init__(self, name: str, path_fn: Callable[[], str], schema: str,
                 migrations: Sequence[str] = ()):
        self._name = name
        self._path_fn = path_fn
        self._schema = schema
        self._migrations = tuple(migrations)

    def get(self) -> sqlite3.Connection:
        path = os.path.expanduser(self._path_fn())
        cache = getattr(_local, 'conns', None)
        if cache is None:
            cache = _local.conns = {}
        key = (self._name, path)
        conn = cache.get(key)
        if conn is None:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            conn = sqlite3.connect(path, timeout=30)
            conn.row_factory = sqlite3.Row
            conn.executescript(self._schema)
            for stmt in self._migrations:
                try:
                    conn.execute(stmt)
                except sqlite3.OperationalError:
                    pass  # column already exists
            conn.commit()
            # Drop stale connections for this logical DB (old $HOME).
            for k in [k for k in cache if k[0] == self._name and k != key]:
                try:
                    cache.pop(k).close()
                except sqlite3.Error:
                    pass
            cache[key] = conn
        return conn
