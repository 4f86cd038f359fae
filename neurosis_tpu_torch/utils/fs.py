"""The port's filesystem layer, in place of ``fsspec.core.url_to_fs`` and
``fsspec.filesystem`` for the blob checkpoints (``checkpoint/blob.py``) and
the Mongo datasets' image fetch (``data/mongo.py``).

Two backends are the port's own and always used: ``file`` (plain ``open`` and
``os``) and ``memory`` (one store per process, paths ``/a/b`` as fsspec's
memory filesystem keeps them). Any other scheme (``gs``, ``s3``, ``az``,
``http``, ...) goes through ``fsspec`` with its storage options, imported at
that call; the card's machine has no fsspec, so there such a URL raises
``ImportError`` naming the scheme and the package.

Both backends have the methods the two users call, with fsspec's
signatures: ``makedirs``, ``open``, ``ls``, ``isfile``, ``rm`` and ``cat``.
"""

from __future__ import annotations

import io
import os
import threading
from pathlib import Path


def split_url(url: str) -> tuple[str, str]:
    """(scheme, the rest) of ``scheme://rest``; a plain path is ``file``."""
    url = str(url)
    if "://" in url:
        scheme, rest = url.split("://", 1)
        return scheme.lower(), rest
    return "file", url


class LocalFileSystem:
    """Files on this machine's disk."""

    @staticmethod
    def strip(url: str) -> str:
        return os.path.abspath(split_url(url)[1])

    def makedirs(self, path: str, exist_ok: bool = False) -> None:
        os.makedirs(self.strip(path), exist_ok=exist_ok)

    def open(self, path: str, mode: str = "rb"):
        return open(self.strip(path), mode)

    def ls(self, path: str, detail: bool = False) -> list:
        path = self.strip(path)
        if not os.path.isdir(path):
            raise FileNotFoundError(path)
        return sorted(os.path.join(path, n) for n in os.listdir(path))

    def isfile(self, path: str) -> bool:
        return os.path.isfile(self.strip(path))

    def rm(self, path: str) -> None:
        os.remove(self.strip(path))

    def cat(self, path: str):
        return Path(self.strip(path)).read_bytes()


class _MemoryStore:
    """The bytes of every ``memory://`` file of this process, by path."""

    def __init__(self):
        self.files: dict[str, bytes] = {}
        self.dirs: set[str] = {"/"}
        self.lock = threading.Lock()


_STORE = _MemoryStore()


class _MemoryFile(io.BytesIO):
    """A file opened for writing: its bytes land in the store on close."""

    def __init__(self, store: _MemoryStore, path: str):
        super().__init__()
        self.store, self.path = store, path

    def close(self) -> None:
        if not self.closed:
            with self.store.lock:
                self.store.files[self.path] = self.getvalue()
        super().close()


class MemoryFileSystem:
    """Files in this process's memory, shared by every instance: a
    checkpoint written by one run is read by the next run of the process,
    and by no other process."""

    store = _STORE

    @staticmethod
    def strip(url: str) -> str:
        return "/" + split_url(url)[1].strip("/")

    def makedirs(self, path: str, exist_ok: bool = False) -> None:
        path = self.strip(path)
        with self.store.lock:
            if path in self.store.dirs and not exist_ok:
                raise FileExistsError(path)
            parts = path.strip("/").split("/")
            self.store.dirs.update("/" + "/".join(parts[:i]) for i in range(1, len(parts) + 1))

    def open(self, path: str, mode: str = "rb"):
        path = self.strip(path)
        if mode == "wb":
            self.makedirs(path.rsplit("/", 1)[0] or "/", exist_ok=True)
            return _MemoryFile(self.store, path)
        if mode != "rb":
            raise ValueError(f"memory files open as 'rb' or 'wb', not {mode!r}")
        with self.store.lock:
            if path not in self.store.files:
                raise FileNotFoundError(path)
            return io.BytesIO(self.store.files[path])

    def ls(self, path: str, detail: bool = False) -> list:
        path = self.strip(path)
        prefix = path.rstrip("/") + "/"
        with self.store.lock:
            if path not in self.store.dirs and path not in self.store.files:
                raise FileNotFoundError(path)
            names = {prefix + p[len(prefix):].split("/", 1)[0] for p in [*self.store.files, *self.store.dirs]
                     if p.startswith(prefix) and p != prefix}
        return sorted(names)

    def isfile(self, path: str) -> bool:
        with self.store.lock:
            return self.strip(path) in self.store.files

    def rm(self, path: str) -> None:
        path = self.strip(path)
        with self.store.lock:
            if path not in self.store.files:
                raise FileNotFoundError(path)
            del self.store.files[path]

    def cat(self, path: str):
        with self.open(path) as f:
            return f.read()


_OWN = {"file": LocalFileSystem, "memory": MemoryFileSystem}


def _fsspec(scheme: str):
    try:
        import fsspec
    except ImportError as e:
        raise ImportError(f"the {scheme}:// scheme needs the fsspec package (and its {scheme} backend), "
                          "which is not installed") from e
    return fsspec


def filesystem(protocol: str, **storage_options):
    """The filesystem of ``protocol``: the port's own for file and memory,
    else fsspec's, built with ``storage_options``."""
    protocol = str(protocol).lower()
    if protocol in _OWN:
        return _OWN[protocol]()
    try:
        return _fsspec(protocol).filesystem(protocol, **storage_options)
    except ValueError as e:  # fsspec: "Protocol not known"
        raise ValueError(f"no filesystem for the scheme {protocol!r}: {e}") from e


def url_to_fs(url: str, **storage_options) -> tuple:
    """(filesystem, path inside it) of ``url``, as ``fsspec.core.url_to_fs``."""
    scheme, _ = split_url(url)
    if scheme in _OWN:
        fs = _OWN[scheme]()
        return fs, fs.strip(url)
    try:
        return _fsspec(scheme).core.url_to_fs(url, **storage_options)
    except ValueError as e:
        raise ValueError(f"no filesystem for the scheme {scheme!r} of {url!r}: {e}") from e
