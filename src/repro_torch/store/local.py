"""Concrete object stores: in-memory and real-directory backed."""

from __future__ import annotations

import contextlib
import os
import shutil
import threading

from repro_torch.store.base import MultipartUpload, ObjectMeta, ObjectStore, StoreError


class MemStore(ObjectStore):
    """Dict-backed store; the substrate beneath SimS3Store."""

    def __init__(self) -> None:
        self._objects: dict[str, bytes] = {}
        self._lock = threading.Lock()

    def list_objects(self, prefix: str = "") -> list[ObjectMeta]:
        with self._lock:
            return [
                ObjectMeta(k, len(v))
                for k, v in sorted(self._objects.items())
                if k.startswith(prefix)
            ]

    def size(self, key: str) -> int:
        with self._lock:
            try:
                return len(self._objects[key])
            except KeyError:
                raise StoreError(f"no such object: {key}") from None

    def get_range(self, key: str, start: int, end: int) -> bytes:
        with self._lock:
            try:
                data = self._objects[key]
            except KeyError:
                raise StoreError(f"no such object: {key}") from None
        if start < 0 or end < start:
            raise StoreError(f"bad range [{start}, {end})")
        return data[start:end]

    def get_ranges(self, key: str, spans: list[tuple[int, int]]) -> list[bytes]:
        with self._lock:
            try:
                data = self._objects[key]
            except KeyError:
                raise StoreError(f"no such object: {key}") from None
        for start, end in spans:
            if start < 0 or end < start:
                raise StoreError(f"bad range [{start}, {end})")
        return [data[start:end] for start, end in spans]

    def get(self, key: str) -> bytes:
        with self._lock:
            try:
                return self._objects[key]
            except KeyError:
                raise StoreError(f"no such object: {key}") from None

    def put(self, key: str, data: bytes) -> None:
        with self._lock:
            self._objects[key] = bytes(data)

    def delete(self, key: str) -> None:
        with self._lock:
            self._objects.pop(key, None)


class _DirMultipartUpload(MultipartUpload):
    """Disk-backed multipart: parts land as sibling `.mpart` files (bounded
    memory), and complete() concatenates them into the final path with the
    same tmp-then-replace atomic publish the store's put() uses."""

    def _part_path(self, index: int) -> str:
        return self.store._path(self.key) + f".mpart{index:06d}"

    def put_part(self, index: int, data: bytes) -> None:
        if index < 0:
            raise StoreError(f"multipart {self.key!r}: bad part index {index}")
        with self._lock:
            if self._aborted:
                raise StoreError(f"multipart {self.key!r}: upload aborted")
            self._parts[index] = b""   # presence marker; bytes live on disk
        path = self._part_path(index)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
        # An abort() racing this upload may have swept the part files
        # before our replace landed — re-check and clean up, or the part
        # would be orphaned on disk forever (abort only removes parts it
        # saw registered at sweep time).
        with self._lock:
            aborted = self._aborted
        if aborted:
            with contextlib.suppress(OSError):
                os.remove(path)
            raise StoreError(f"multipart {self.key!r}: upload aborted")

    def complete(self) -> None:
        with self._lock:
            if self._aborted:
                raise StoreError(f"multipart {self.key!r}: upload aborted")
            indexes = sorted(self._parts)
        if indexes != list(range(len(indexes))):
            raise StoreError(
                f"multipart {self.key!r}: non-contiguous parts {indexes}"
            )
        final = self.store._path(self.key)
        os.makedirs(os.path.dirname(final) or ".", exist_ok=True)
        # Unique tmp per attempt: hedged/retried completes may run
        # concurrently and must not clobber each other's staging file.
        tmp = f"{final}.tmp{os.getpid()}-{threading.get_ident()}"
        try:
            with open(tmp, "wb") as out:
                for i in indexes:
                    with open(self._part_path(i), "rb") as f:
                        shutil.copyfileobj(f, out)
            os.replace(tmp, final)
        except OSError as e:
            with contextlib.suppress(OSError):
                os.remove(tmp)
            # A concurrent attempt may have published and removed the
            # part files out from under us — that's success, not failure.
            if not os.path.exists(final):
                raise StoreError(
                    f"multipart {self.key!r}: complete failed: {e}"
                ) from e
        for i in indexes:
            with contextlib.suppress(OSError):
                os.remove(self._part_path(i))

    def abort(self) -> None:
        with self._lock:
            self._aborted = True
            indexes = sorted(self._parts)
            self._parts.clear()
        for i in indexes:
            with contextlib.suppress(OSError):
                os.remove(self._part_path(i))


class DirStore(ObjectStore):
    """Real-filesystem store (checkpoints, local datasets)."""

    def __init__(self, root: str) -> None:
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        path = os.path.normpath(os.path.join(self.root, key))
        if not path.startswith(os.path.normpath(self.root)):
            raise StoreError(f"key escapes store root: {key}")
        return path

    def list_objects(self, prefix: str = "") -> list[ObjectMeta]:
        metas = []
        for dirpath, _, filenames in os.walk(self.root):
            for fn in filenames:
                full = os.path.join(dirpath, fn)
                key = os.path.relpath(full, self.root)
                if key.startswith(prefix):
                    metas.append(ObjectMeta(key, os.path.getsize(full)))
        return sorted(metas, key=lambda m: m.key)

    def size(self, key: str) -> int:
        try:
            return os.path.getsize(self._path(key))
        except OSError:
            raise StoreError(f"no such object: {key}") from None

    def get_range(self, key: str, start: int, end: int) -> bytes:
        try:
            with open(self._path(key), "rb") as f:
                f.seek(start)
                return f.read(end - start)
        except OSError:
            raise StoreError(f"no such object: {key}") from None

    def get_ranges(self, key: str, spans: list[tuple[int, int]]) -> list[bytes]:
        # One open per call: every span is a seek + read on the same fd.
        try:
            with open(self._path(key), "rb") as f:
                out = []
                for start, end in spans:
                    f.seek(start)
                    out.append(f.read(end - start))
                return out
        except OSError:
            raise StoreError(f"no such object: {key}") from None

    def get(self, key: str) -> bytes:
        try:
            with open(self._path(key), "rb") as f:
                return f.read()
        except OSError:
            raise StoreError(f"no such object: {key}") from None

    def put(self, key: str, data: bytes) -> None:
        path = self._path(key)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)  # atomic publish

    def start_multipart(self, key: str) -> MultipartUpload:
        self._path(key)  # validate the key before any part lands
        return _DirMultipartUpload(self, key)

    def delete(self, key: str) -> None:
        try:
            os.remove(self._path(key))
        except OSError:
            pass
