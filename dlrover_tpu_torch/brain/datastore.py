"""Metrics datastore (sqlite).

Own copy of the JAX package's ``brain/datastore.py``, after
dlrover/go/brain/pkg/datastore/ (MySQL): job metric records keyed by job
and record type, queried newest first for the optimizer algorithms. The
schema and the query order are the JAX store's, so either package reads
the other's database file.
"""

from __future__ import annotations

import json
import sqlite3
import threading
import time
from typing import Any, Dict, List, Optional

_SCHEMA = """
CREATE TABLE IF NOT EXISTS job_metrics (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    job_name TEXT NOT NULL,
    job_uuid TEXT DEFAULT '',
    record_type TEXT NOT NULL,
    payload TEXT NOT NULL,
    created_at REAL NOT NULL
);
CREATE INDEX IF NOT EXISTS idx_job_metrics_job
    ON job_metrics (job_name, record_type);
"""


class MetricsStore:
    def __init__(self, path: str = ":memory:"):
        # one connection guarded by a lock: sqlite objects are not
        # thread-safe across the gRPC handler pool
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.Lock()
        with self._lock:
            self._conn.executescript(_SCHEMA)
            self._conn.commit()

    def persist(self, job_name: str, record_type: str,
                payload: Dict[str, Any], job_uuid: str = "") -> None:
        with self._lock:
            self._conn.execute(
                "INSERT INTO job_metrics (job_name, job_uuid, record_type,"
                " payload, created_at) VALUES (?, ?, ?, ?, ?)",
                (job_name, job_uuid, record_type, json.dumps(payload),
                 time.time()),
            )
            self._conn.commit()

    def query(self, job_name: Optional[str] = None,
              record_type: Optional[str] = None,
              limit: int = 1000) -> List[Dict[str, Any]]:
        sql = ("SELECT job_name, job_uuid, record_type, payload, created_at"
               " FROM job_metrics WHERE 1=1")
        args: List[Any] = []
        if job_name:
            sql += " AND job_name = ?"
            args.append(job_name)
        if record_type:
            sql += " AND record_type = ?"
            args.append(record_type)
        sql += " ORDER BY id DESC LIMIT ?"
        args.append(limit)
        with self._lock:
            rows = self._conn.execute(sql, args).fetchall()
        return [
            {
                "job_name": r[0],
                "job_uuid": r[1],
                "record_type": r[2],
                "payload": json.loads(r[3]),
                "created_at": r[4],
            }
            for r in rows
        ]

    def completed_jobs(self, limit: int = 50) -> List[str]:
        """Names of jobs that reported a successful exit (cold-start
        history source)."""
        with self._lock:
            rows = self._conn.execute(
                "SELECT job_name, payload FROM job_metrics"
                " WHERE record_type = 'job_exit' ORDER BY id DESC LIMIT ?",
                (limit * 4,),
            ).fetchall()
        names: List[str] = []
        seen = set()
        for name, payload in rows:
            if name in seen:
                continue
            seen.add(name)
            try:
                if json.loads(payload).get("stage") == "succeeded":
                    names.append(name)
            except json.JSONDecodeError:
                continue
            if len(names) >= limit:
                break
        return names
