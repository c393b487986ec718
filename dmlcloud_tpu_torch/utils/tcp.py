"""TCP helpers for rendezvous address exchange.

A copy of ``dmlcloud_tpu/utils/tcp.py`` (free-port discovery and local-IP
enumeration), used by the MPI bootstrap path to agree on the process group's
rendezvous address.
"""

from __future__ import annotations

import socket
import subprocess


def find_free_port() -> int:
    """Bind port 0 to let the OS pick a free TCP port, and return it."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("", 0))
        return s.getsockname()[1]


def get_local_ips(use_hostname: bool = True) -> list[str]:
    """All IPs of this host. Tries ``hostname -I`` first (covers multi-NIC
    cluster nodes), then falls back to a DNS lookup of the hostname."""
    if use_hostname:
        try:
            out = subprocess.run(["hostname", "-I"], capture_output=True, text=True, timeout=5)
            ips = out.stdout.strip().split()
            if ips:
                return ips
        except Exception:
            pass
    try:
        return socket.gethostbyname_ex(socket.gethostname())[2]
    except OSError:
        return ["127.0.0.1"]
