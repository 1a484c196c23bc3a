"""``cache://`` addressing: the daemon's entry in the storage scheme
registry.

A cache URI names a *daemon endpoint*, not a byte store:

* ``cache:///run/igt.sock``      — Unix-domain socket (the default
  deployment: same-node clients, payload bytes over shared memory);
* ``cache://host:port``          — TCP (remote clients, payload bytes
  streamed inline over the socket);
* query params (``?fetch_bytes=true&heartbeat_s=2``) are coerced like
  every other scheme's and forwarded to the client constructor.

``storage.api.open_store("cache://...")`` therefore resolves to a
:class:`DaemonAddress` — a picklable, re-openable handle — and
``core.client.open_cache("cache://...")`` short-circuits to a
``repro_torch.daemon.RemoteCacheClient`` connected to that endpoint.  This
module stays dependency-light (no sockets, no numpy) so the registry
can import it without dragging the server in.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional
from urllib.parse import urlsplit

__all__ = ["DaemonAddress", "format_cache_uri", "parse_cache_uri"]

SCHEME = "cache"


@dataclass
class DaemonAddress:
    """Where a :class:`~repro_torch.daemon.CacheDaemon` listens.

    ``kind`` is ``"uds"`` (``path`` set) or ``"tcp"`` (``host``/``port``
    set).  ``params`` carries coerced query items from the URI;
    ``open_cache`` forwards the recognized ones to the remote client.
    """

    kind: str                                   # "uds" | "tcp"
    path: Optional[str] = None                  # uds socket path
    host: Optional[str] = None                  # tcp host
    port: Optional[int] = None                  # tcp port
    params: Dict[str, object] = field(default_factory=dict, compare=False)
    # provenance stamp (open_store sets it); never part of equality
    uri: Optional[str] = field(default=None, compare=False)

    # open_cache dispatches on this instead of importing the class
    is_cache_address = True

    @property
    def display(self) -> str:
        return self.path if self.kind == "uds" else f"{self.host}:{self.port}"

    def connect_args(self):
        """``(family_kind, address)`` for ``socket.connect``."""
        if self.kind == "uds":
            return "uds", self.path
        return "tcp", (self.host, self.port)


def parse_cache_uri(uri: str, **params) -> DaemonAddress:
    """``cache:///sock/path`` → uds address, ``cache://host:port`` →
    tcp address.  A bare ``cache://`` (no endpoint) is an error."""
    url = urlsplit(uri)
    if url.scheme and url.scheme != SCHEME:
        raise ValueError(f"not a cache:// URI: {uri!r}")
    return address_from_url(url, **params)


def address_from_url(url, **params) -> DaemonAddress:
    """Scheme-registry factory (``storage.api.register_scheme``): the
    ``urlsplit`` result + coerced query params → :class:`DaemonAddress`."""
    netloc, path = url.netloc, url.path
    if netloc:
        host, sep, port = netloc.rpartition(":")
        if sep and port.isdigit() and not path:
            return DaemonAddress("tcp", host=host or "127.0.0.1",
                                 port=int(port), params=params)
        # netloc without a port: a relative socket path ("cache://x.sock")
        path = netloc + path
    if not path:
        raise ValueError(
            f"cache URI {url.geturl()!r} names no endpoint; expected "
            f"cache:///path/to.sock or cache://host:port")
    return DaemonAddress("uds", path=path, params=params)


def format_cache_uri(address: DaemonAddress) -> str:
    if address.kind == "uds":
        return f"cache://{address.path}"
    return f"cache://{address.host}:{address.port}"


def _register() -> None:
    # storage.api's lazy builtin loader imports this module, and a
    # direct ``import repro_torch.daemon`` lands here too — either way the
    # cache:// scheme resolves through the one shared registry
    from ..storage.api import register_scheme
    register_scheme(SCHEME, address_from_url)


_register()
