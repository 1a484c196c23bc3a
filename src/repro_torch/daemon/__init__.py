"""Cache-as-a-service: the network cache daemon and its thin clients.

``CacheDaemon`` wraps one ``CacheClient`` (in-process sharded engine or
the supervised multi-process driver) behind a framed socket protocol —
Unix-domain socket by default, TCP optionally — so many independent
processes share one unified cache (the Hoard deployment shape,
arXiv:1812.00669).  ``RemoteCacheClient`` is the thin client;
``open_cache("cache://<sock-or-host:port>")`` builds one from a URI.

Survivability: ``CacheJournal`` makes daemon state
crash-consistent (append-only journal + periodic snapshots → warm
restart), ``DaemonSupervisor`` respawns a crashed daemon on the same
socket path inside a restart budget, and the client auto-reconnects
with degraded reads while the daemon is away.

See docs/API.md ("Cache daemon") and docs/RELIABILITY.md (the
fault-of-the-client story: session leases, heartbeats, reclamation;
and the fault-of-the-daemon story: journal, warm restart, reconnect).
"""
from .client import RemoteCacheClient
from .journal import CacheJournal
from .server import CacheDaemon
from .supervisor import DaemonSupervisor
from .uri import DaemonAddress, format_cache_uri, parse_cache_uri

__all__ = ["CacheDaemon", "CacheJournal", "DaemonAddress",
           "DaemonSupervisor", "RemoteCacheClient", "format_cache_uri",
           "parse_cache_uri"]
