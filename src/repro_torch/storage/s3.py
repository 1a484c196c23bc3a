"""Ranged object-store scheme: ``s3://`` over HTTP, plus ``mock-s3://``.

:class:`S3Store` is the real far side of the tiered hierarchy — a
BackingStore v2 implementation over ranged HTTP GETs (``Range:
bytes=a-b`` → 206 Partial Content), speaking to any endpoint that serves
the two-request protocol below.  It deliberately implements **no retry
of its own**: failures are raised as the typed taxonomy
(:class:`TransientStoreError` for 5xx / timeouts / connection drops,
:class:`StoreError` for 404/416) so the client's existing
``RetryPolicy`` / ``CircuitBreaker`` / deadline semantics apply
unchanged, exactly as they do for every other scheme.

Protocol (subset of S3's REST shape, enough for a read-only cache):

* ``GET /<bucket>?list`` → ``{"objects": [[key, size], ...]}`` — the
  bucket listing, loaded once at open to build the kernel's metadata
  tree (dataset top = bucket name, directories from key prefixes);
* ``GET /<bucket>/<key>`` with an optional ``Range`` header → the object
  bytes (206 for a satisfied range, 200 full-body fallback is sliced).

:class:`MockS3Server` is the deterministic in-process double for tier-1:
a ``ThreadingHTTPServer`` on ``127.0.0.1:<ephemeral>`` that serves the
same protocol from objects registered via :meth:`MockS3Server.add_object`
— explicit bytes, or synthesized on the fly from the shared
``path_seed``/``synth_range`` stream so a multi-GB bucket costs no RAM.
No test touches the network: the socket never leaves loopback.

The ``mock-s3://<name>/<bucket>?dirs=D&files=N&file_kb=K&seed=S`` scheme
goes one step further for the process driver: the URI *is* the bucket
spec.  A per-process registry maps (name, bucket, spec) to a running
mock server, so ``store_spec``/``resolve_store_spec`` round-trips — a
respawned shard worker re-opens the URI and gets its own identical
deterministic server (content is seeded by path, not by process).
"""
from __future__ import annotations

import http.client
import json
import socket
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Sequence, Tuple
from urllib.parse import quote, unquote, urlsplit

import numpy as np

from ..core.types import MB, PathT
from .api import (BackingStore, RangeRequest, StoreCapabilities, StoreError,
                  StoreMetaIndex, TransientStoreError, path_seed,
                  register_scheme, synth_range)

__all__ = ["MockS3Server", "S3Store", "mock_object_bytes"]


def _object_seed(bucket: str, key: str, seed: int = 0) -> int:
    """Content seed for one object: the shared path seed, shifted by the
    bucket-level ``seed`` knob so distinct mock buckets differ."""
    path = (bucket,) + tuple(key.split("/"))
    return (path_seed(path) ^ (seed * 0x9E3779B97F4A7C15)) & ((1 << 64) - 1)


def mock_object_bytes(bucket: str, key: str, offset: int, length: int,
                      seed: int = 0) -> np.ndarray:
    """Expected bytes of a synthesized mock-s3 object range — the oracle
    tests compare fetched payloads against."""
    return synth_range(_object_seed(bucket, key, seed), offset, length)


# ---------------------------------------------------------------------------
# the deterministic in-process server
# ---------------------------------------------------------------------------

class MockS3Server:
    """Loopback HTTP object server for tier-1 (no network, no deps).

    Objects are either explicit bytes or ``("synth", seed, size)`` specs
    materialized per request window — registering a large object costs
    nothing until someone reads it.
    """

    def __init__(self) -> None:
        # bucket -> key -> ("bytes", ndarray) | ("synth", seed, size)
        self._objects: Dict[str, Dict[str, tuple]] = {}
        self._lock = threading.Lock()
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):   # keep test output clean
                pass

            def do_GET(self):
                server._handle(self)

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.httpd.daemon_threads = True
        self.host, self.port = self.httpd.server_address[:2]
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        name="mock-s3", daemon=True)
        self._thread.start()

    # -- registration --------------------------------------------------------
    def add_object(self, bucket: str, key: str,
                   data: Optional[bytes] = None,
                   size: Optional[int] = None, seed: int = 0) -> None:
        """Register one object: explicit ``data`` bytes, or a synthesized
        body of ``size`` bytes keyed by (bucket, key, seed)."""
        with self._lock:
            objs = self._objects.setdefault(bucket, {})
            if data is not None:
                arr = np.frombuffer(bytes(data), dtype=np.uint8).copy()
                objs[key] = ("bytes", arr)
            elif size is not None:
                objs[key] = ("synth", _object_seed(bucket, key, seed),
                             int(size))
            else:
                raise ValueError("add_object needs data= or size=")

    def populate(self, bucket: str, dirs: int = 2, files: int = 4,
                 file_kb: int = 64, seed: int = 0) -> None:
        """The canonical synthetic bucket layout the ``mock-s3://`` scheme
        builds from its URI spec: ``<dd>/<iii>.bin`` keys."""
        for d in range(int(dirs)):
            for i in range(int(files)):
                self.add_object(bucket, f"{d:02d}/{i:03d}.bin",
                                size=int(file_kb) * 1024, seed=int(seed))

    def uri(self, bucket: str) -> str:
        """An ``s3://`` URI addressing ``bucket`` on this server."""
        return f"s3://{self.host}:{self.port}/{quote(bucket)}"

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()

    # -- request handling ----------------------------------------------------
    def _object_size(self, entry: tuple) -> int:
        return len(entry[1]) if entry[0] == "bytes" else entry[2]

    def _object_range(self, entry: tuple, start: int, length: int) -> bytes:
        if entry[0] == "bytes":
            return entry[1][start:start + length].tobytes()
        return synth_range(entry[1], start, length).tobytes()

    def _handle(self, req: BaseHTTPRequestHandler) -> None:
        url = urlsplit(req.path)
        parts = [unquote(p) for p in url.path.split("/") if p]
        if not parts:
            return self._error(req, 404, "no bucket")
        bucket, key = parts[0], "/".join(parts[1:])
        with self._lock:
            objs = self._objects.get(bucket)
            entry = objs.get(key) if (objs and key) else None
        if objs is None:
            return self._error(req, 404, f"no such bucket {bucket!r}")
        if not key and url.query == "list":
            with self._lock:
                listing = {"objects": [[k, self._object_size(e)]
                                       for k, e in sorted(objs.items())]}
            body = json.dumps(listing).encode()
            req.send_response(200)
            req.send_header("Content-Type", "application/json")
            req.send_header("Content-Length", str(len(body)))
            req.end_headers()
            req.wfile.write(body)
            return
        if entry is None:
            return self._error(req, 404, f"no such key {key!r}")
        total = self._object_size(entry)
        rng = req.headers.get("Range")
        if rng:
            try:
                unit, _, spec = rng.partition("=")
                lo_s, _, hi_s = spec.partition("-")
                if unit.strip() != "bytes" or not lo_s:
                    raise ValueError(rng)
                lo = int(lo_s)
                hi = int(hi_s) if hi_s else total - 1
            except ValueError:
                return self._error(req, 400, f"bad range {rng!r}")
            if lo >= total or hi < lo:
                return self._error(req, 416, f"unsatisfiable range {rng!r}")
            hi = min(hi, total - 1)
            body = self._object_range(entry, lo, hi - lo + 1)
            req.send_response(206)
            req.send_header("Content-Range", f"bytes {lo}-{hi}/{total}")
        else:
            body = self._object_range(entry, 0, total)
            req.send_response(200)
        req.send_header("Content-Type", "application/octet-stream")
        req.send_header("Content-Length", str(len(body)))
        req.end_headers()
        req.wfile.write(body)

    def _error(self, req: BaseHTTPRequestHandler, code: int,
               msg: str) -> None:
        body = msg.encode()
        req.send_response(code)
        req.send_header("Content-Type", "text/plain")
        req.send_header("Content-Length", str(len(body)))
        req.end_headers()
        req.wfile.write(body)


# ---------------------------------------------------------------------------
# the client store
# ---------------------------------------------------------------------------

class S3Store(StoreMetaIndex, BackingStore):
    """Read-only ranged object store over HTTP (``s3://host:port/bucket``).

    Metadata comes from one listing request at open (the whole kernel
    tree derives from it), so a worker respawn re-opening the URI is
    faithful — the class opts into ``reopen_by_uri``.  Connections are
    per-thread keep-alive (``fetch_many`` and the threaded executor's
    workers each reuse their own socket); any transport error drops the
    thread's connection and surfaces as :class:`TransientStoreError` for
    the client's retry machinery.
    """

    reopen_by_uri = True

    def __init__(self, host: str, port: int, bucket: str,
                 block_size: int = 4 * MB, timeout_s: float = 10.0) -> None:
        super().__init__()
        self.host = host
        self.port = int(port)
        self.bucket = bucket
        self.block_size = int(block_size)
        self.timeout_s = float(timeout_s)
        self._local = threading.local()
        self._load_listing()

    # -- transport -----------------------------------------------------------
    def _conn(self) -> http.client.HTTPConnection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = http.client.HTTPConnection(self.host, self.port,
                                              timeout=self.timeout_s)
            self._local.conn = conn
        return conn

    def _drop_conn(self) -> None:
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            try:
                conn.close()
            except OSError:  # pragma: no cover - close is best-effort
                pass
            self._local.conn = None

    def _request(self, target: str,
                 headers: Optional[dict] = None) -> Tuple[int, bytes, dict]:
        try:
            conn = self._conn()
            conn.request("GET", target, headers=headers or {})
            resp = conn.getresponse()
            body = resp.read()
            return resp.status, body, dict(resp.getheaders())
        except (http.client.HTTPException, socket.timeout,
                ConnectionError, OSError) as e:
            # a dropped/hung/refused connection is the canonical transient
            # failure: reset the keep-alive socket and let RetryPolicy
            # decide how many more times this store is worth trying
            self._drop_conn()
            raise TransientStoreError(
                f"s3://{self.host}:{self.port}: {type(e).__name__}: {e}"
            ) from e

    # -- metadata ------------------------------------------------------------
    def _load_listing(self) -> None:
        status, body, _ = self._request(f"/{quote(self.bucket)}?list")
        if status != 200:
            raise StoreError(
                f"s3://{self.host}:{self.port}/{self.bucket}: listing "
                f"failed with HTTP {status}")
        try:
            objects = json.loads(body.decode())["objects"]
        except (ValueError, KeyError) as e:
            raise StoreError(f"s3://: malformed listing: {e}") from e
        for key, size in objects:
            path = (self.bucket,) + tuple(str(key).split("/"))
            self._add_path(path, int(size))
        self._invalidate_derived()

    def _add_path(self, path: PathT, size: int) -> None:
        if path in self._files:
            return
        for depth in range(len(path)):
            parent, name = path[:depth], path[depth]
            names = self._dirs.setdefault(parent, [])
            if (parent, name) not in self._index:
                self._index[(parent, name)] = len(names)
                names.append(name)
        self._register_file(path, size)

    def _key_for(self, file_path: PathT) -> str:
        if not file_path or file_path[0] != self.bucket:
            raise StoreError(f"s3://: path {'/'.join(file_path)} outside "
                             f"bucket {self.bucket!r}")
        return "/".join(file_path[1:])

    # -- BackingStore v2 -----------------------------------------------------
    def capabilities(self) -> StoreCapabilities:
        return StoreCapabilities(ranges=True, batching=True, concurrency=4)

    def fetch_range(self, path: PathT, offset: int,
                    length: int) -> np.ndarray:
        file_path, abs_off = self._absolute_range(path, offset, length)
        if not self.is_file(file_path):
            raise StoreError(f"s3://: no such object "
                             f"{'/'.join(file_path)}")
        size = self.file_size(file_path)
        end = abs_off + length
        if abs_off < 0 or end > size:
            raise StoreError(f"s3://: range [{abs_off}, {end}) outside "
                             f"{'/'.join(file_path)} ({size} bytes)")
        if length <= 0:
            return np.empty(0, dtype=np.uint8)
        key = self._key_for(file_path)
        target = f"/{quote(self.bucket)}/{quote(key)}"
        headers = {"Range": f"bytes={abs_off}-{end - 1}"}
        status, body, _ = self._request(target, headers)
        if status == 206:
            data = body
        elif status == 200:
            data = body[abs_off:end]     # server ignored the range header
        elif status in (404, 416):
            raise StoreError(f"s3://: HTTP {status} for {target}")
        elif 500 <= status < 600:
            raise TransientStoreError(f"s3://: HTTP {status} for {target}")
        else:
            raise StoreError(f"s3://: unexpected HTTP {status} for {target}")
        if len(data) != length:
            raise TransientStoreError(
                f"s3://: short read for {target}: wanted {length} bytes, "
                f"got {len(data)}")
        arr = np.frombuffer(data, dtype=np.uint8)
        arr.flags.writeable = False
        return arr

    def fetch_many(self, requests: Sequence[RangeRequest]
                   ) -> List[np.ndarray]:
        # one keep-alive connection serves the whole batch in order —
        # the "batching" capability is connection reuse, not pipelining
        return [self.fetch_range(p, o, n) for p, o, n in requests]

    # -- process-driver plumbing --------------------------------------------
    def __getstate__(self):
        state = self.__dict__.copy()
        del state["_local"]      # per-thread sockets never cross a fork
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._local = threading.local()


# ---------------------------------------------------------------------------
# scheme factories
# ---------------------------------------------------------------------------

def _s3_factory(url, **params):
    host = url.hostname or "127.0.0.1"
    port = url.port or 80
    parts = [unquote(p) for p in url.path.split("/") if p]
    if not parts:
        raise ValueError(f"s3:// URI needs a bucket path: {url!r}")
    return S3Store(host, port, parts[0], **params)


register_scheme("s3", _s3_factory)


# (name, bucket, frozen spec) -> MockS3Server; process-lifetime servers so
# the same mock-s3:// URI resolves to the same endpoint within a process,
# and a *respawned worker* re-creates an identical one from the URI alone
_MOCK_SERVERS: Dict[tuple, MockS3Server] = {}
_MOCK_LOCK = threading.Lock()


def _mock_s3_factory(url, **params):
    name = url.netloc or "default"
    parts = [unquote(p) for p in url.path.split("/") if p]
    bucket = parts[0] if parts else "data"
    spec = {k: params.pop(k) for k in ("dirs", "files", "file_kb", "seed")
            if k in params}
    reg_key = (name, bucket, tuple(sorted(spec.items())))
    with _MOCK_LOCK:
        server = _MOCK_SERVERS.get(reg_key)
        if server is None:
            server = MockS3Server()
            server.populate(bucket, **spec)
            _MOCK_SERVERS[reg_key] = server
    return S3Store(server.host, server.port, bucket, **params)


register_scheme("mock-s3", _mock_s3_factory)
