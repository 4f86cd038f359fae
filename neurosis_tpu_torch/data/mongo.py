"""Mongo + blob-store image datasets (port of neurosis_tpu/data/mongo.py;
parity: dataset/mongo/{base,settings,aspect,nobucket,nocaption}.py and
dataset/loaders.py).

As in the JAX package:
  - ``MongoSettings`` with its ``mongo_`` environment variables and ``Query``
    (settings.py:20-138), as dataclasses here (no pydantic); ``query_hash``
    is JAX's, so both packages key a query alike. The environment is read
    case-insensitively, as the reference's pydantic-settings reads it (the
    JAX package keeps the key's case and so drops ``MONGO_URI``);
  - the metadata pulled once through a plain pymongo cursor (filter,
    projection, sort, limit) and cached on disk by query hash and node
    (base.py:114-202): the port's cache is a pickle of its list of rows,
    ``meta_<hash>_<node>.rows.pkl``, apart from JAX's zstd-pickled
    DataFrame (``.pkl.zst``), which needs pandas and zstandard. A cache hit
    touches no Mongo client, so a run from a written cache needs no pymongo;
  - fork-aware client refresh (base.py:157-175): a process that finds
    another pid opens its own Mongo client and filesystem;
  - the image fetch with retries and backoff (base.py:234-262) through
    ``utils/fs.py`` (``fs_type``: ``file`` and ``memory`` the port's own,
    ``s3`` and the rest fsspec's), under ``path_prefix``;
  - the ``data_transforms`` chain (base.py:229-232), each seeing the sample
    and its metadata row;
  - the aspect buckets' same-bucket batch schedule and the square datasets'
    shuffled chunks, drawn from ``np.random.default_rng(seed)`` in JAX's
    order, so both packages give the same batches and crops for the same
    rows and seed.
PNGs decode through ``data/png.py``, other formats through Pillow at the
call. ``get_batch`` takes the generator a batch draws from, as the folder
datasets do (``data/prefetch.py``). pymongo is imported where the client is
first needed.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import os
import pickle
import tempfile
import time
from pathlib import Path
from typing import Any, Generator, Optional, Sequence

import numpy as np

from ..utils.fs import filesystem
from .utils import collate_dict_stack, cropped_sample_fields, decode_image_bytes, same_bucket_batches, \
    shuffled_chunk_batches

logger = logging.getLogger(__name__)

_TRUE, _FALSE = ("1", "on", "t", "true", "y", "yes"), ("0", "off", "f", "false", "n", "no")


def _bool(value) -> bool:
    """pydantic's reading of a boolean setting."""
    if isinstance(value, bool):
        return value
    text = str(value).strip().lower()
    if text in _TRUE or text in _FALSE:
        return text in _TRUE
    raise ValueError(f"{value!r} is not a boolean")


@dataclasses.dataclass
class Query:
    """Mongo ``find()`` spec (settings.py Query)."""

    filter: dict = dataclasses.field(default_factory=dict)
    projection: Optional[dict] = None
    sort: Optional[list] = None
    limit: int = 0

    def __post_init__(self):
        self.limit = int(self.limit)

    def model_dump(self) -> dict:
        """The fields in pydantic's order (the query hash reads them)."""
        return {"filter": self.filter, "projection": self.projection, "sort": self.sort, "limit": self.limit}


@dataclasses.dataclass
class MongoSettings:
    """Connection settings; ``mongo_`` environment variables override
    (settings.py:42-138). A ``query`` given as a dict becomes a Query."""

    uri: str = "mongodb://localhost:27017"
    database: str = "dataset"
    collection: str = "images"
    query: Query = dataclasses.field(default_factory=Query)
    tls: bool = False

    def __post_init__(self):
        if isinstance(self.query, dict):
            self.query = Query(**self.query)
        self.tls = _bool(self.tls)

    @classmethod
    def from_env(cls, **overrides) -> "MongoSettings":
        env = {k[len("mongo_"):].lower(): v for k, v in os.environ.items() if k.lower().startswith("mongo_")}
        env.update(overrides)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in env.items() if k in known})

    def query_hash(self) -> str:
        payload = repr((self.uri, self.database, self.collection, self.query.model_dump()))
        return hashlib.sha1(payload.encode()).hexdigest()


def _plain(value):
    """A metadata value with BSON's own types (ObjectId, datetime, ...) as
    strings, so the cache unpickles without pymongo."""
    if isinstance(value, dict):
        return {str(k): _plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_plain(v) for v in value]
    if value is None or isinstance(value, (str, bytes, bool, int, float)):
        return value
    return str(value)


class BaseMongoDataset:
    """Metadata-cached, fork-safe, retrying Mongo + blob-store sample source.
    ``samples`` is the list of metadata rows (dicts)."""

    def __init__(
        self,
        settings: Optional[MongoSettings] = None,
        image_url_key: str = "s3_url",
        cache_dir: Optional[str] = None,
        retries: int = 5,
        retry_backoff: float = 1.5,
        s3_endpoint: Optional[str] = None,
        skip_preload: bool = False,
        extra_keys: Sequence[str] | str = (),
        fs_type: str = "s3",  # FilesystemType: file and memory the port's own, the rest fsspec's
        fsspec_kwargs: Optional[dict] = None,
        path_prefix: Optional[str] = None,
        data_transforms: Sequence[Any] = (),  # DataTransform chain (base.py:229-232)
    ):
        self.settings = settings or MongoSettings.from_env()
        self.image_url_key = image_url_key
        self.cache_dir = Path(cache_dir or os.environ.get("NEUROSIS_CACHE")
                              or Path(tempfile.gettempdir()) / "neurosis_cache")
        self.retries = retries
        self.retry_backoff = retry_backoff
        self.s3_endpoint = s3_endpoint or os.environ.get("S3_ENDPOINT_URL")
        self.extra_keys = extra_keys
        self.fs_type = str(fs_type)
        self.fsspec_kwargs = dict(fsspec_kwargs or {})
        self.path_prefix = path_prefix
        self.data_transforms = list(data_transforms)
        self._client = None
        self._fs = None
        self._pid = os.getpid()
        self.samples: Optional[list] = None
        if not skip_preload:
            self.preload()

    def __getstate__(self) -> dict:
        """A prefetch worker opens its own client and filesystem."""
        return dict(self.__dict__, _client=None, _fs=None)

    # -- fork safety (base.py:157-175) --------------------------------------

    def _refresh_clients(self) -> None:
        if os.getpid() != self._pid:
            logger.debug("fork detected — resetting mongo/blob clients")
            self._client = None
            self._fs = None
            self._pid = os.getpid()

    @property
    def client(self):
        self._refresh_clients()
        if self._client is None:
            try:
                import pymongo
            except ImportError as e:
                raise ImportError("MongoDataset requires pymongo (pip install pymongo) to pull its metadata; a "
                                  f"run with the metadata cached in {self._cache_path()} needs none") from e
            self._client = pymongo.MongoClient(self.settings.uri, tls=self.settings.tls)
        return self._client

    @property
    def fs(self):
        self._refresh_clients()
        if self._fs is None:
            kwargs = dict(self.fsspec_kwargs)
            if self.fs_type == "s3" and self.s3_endpoint:
                kwargs.setdefault("client_kwargs", {"endpoint_url": self.s3_endpoint})
            self._fs = filesystem(self.fs_type, **kwargs)
        return self._fs

    # -- metadata (base.py:114-217) ------------------------------------------

    def _cache_path(self) -> Path:
        node = os.environ.get("HOSTNAME", "local")
        return self.cache_dir / f"meta_{self.settings.query_hash()}_{node}.rows.pkl"

    def preload(self, force: bool = False) -> list:
        cache = self._cache_path()
        if cache.exists() and not force:
            with open(cache, "rb") as f:
                self.samples = pickle.load(f)  # written by write_cache, of this program
            logger.info(f"loaded {len(self.samples)} rows from metadata cache {cache}")
            return self.samples

        coll = self.client[self.settings.database][self.settings.collection]
        q = self.settings.query
        cursor = coll.find(q.filter, q.projection)
        if q.sort:
            cursor = cursor.sort(q.sort)
        if q.limit:
            cursor = cursor.limit(q.limit)
        self.samples = [_plain(dict(row)) for row in cursor]
        self.write_cache(self.samples)
        logger.info(f"pulled {len(self.samples)} rows; cached to {cache}")
        return self.samples

    def write_cache(self, rows: list) -> Path:
        """Cache ``rows`` as this query's metadata (what a pull writes)."""
        cache = self._cache_path()
        cache.parent.mkdir(parents=True, exist_ok=True)
        tmp = cache.with_suffix(f".tmp{os.getpid()}")
        with open(tmp, "wb") as f:
            pickle.dump(list(rows), f)
        os.replace(tmp, cache)
        return cache

    # -- image fetch (base.py:234-262) ----------------------------------------

    def _get_image_bytes(self, url: str) -> bytes:
        if self.path_prefix:
            url = self.path_prefix.rstrip("/") + "/" + str(url).lstrip("/")
        delay = 0.5
        last = None
        for attempt in range(self.retries):
            try:
                return self.fs.cat(url)
            except Exception as e:  # noqa: BLE001 — network retry loop
                last = e
                logger.warning(f"fetch {url} failed (attempt {attempt + 1}/{self.retries}): {e}")
                time.sleep(delay)
                delay *= self.retry_backoff
        raise RuntimeError(f"failed to fetch {url} after {self.retries} attempts") from last

    def _apply_transforms(self, sample: dict, row: dict) -> dict:
        """The DataTransform chain (base.py:229-232): each sees the sample
        and a copy of its metadata row."""
        for tfm in self.data_transforms:
            sample = tfm(sample, dict(row))
        return sample

    def _load_image(self, url: str) -> np.ndarray:
        return decode_image_bytes(self._get_image_bytes(url), str(url))

    def __len__(self) -> int:
        return 0 if self.samples is None else len(self.samples)

    def get_batch(self, indices: Sequence[int], rng: Optional[np.random.Generator] = None) -> dict:
        """The collated samples; their crops drawn from ``rng`` when given,
        else from the dataset's own generator."""
        return collate_dict_stack([self._item(i, self.rng if rng is None else rng) for i in indices])

    def __getitem__(self, index: int) -> dict:
        return self._item(index, self.rng)


class MongoAspectDataset(BaseMongoDataset):
    """Mongo rows in aspect buckets (aspect.py:38-232): a row's bucket from
    its ``bucket_idx`` field when every row has one, else from its aspect."""

    def __init__(
        self,
        buckets=None,
        batch_size: int = 1,
        image_key: str = "image",
        caption_key: str = "caption",
        resolution_key: str = "resolution",
        aspect_key: str = "aspect",
        clamp_orig: bool = True,
        seed: int = 0,
        **kwargs,
    ):
        from .aspect import SDXLBucketList

        self.buckets = buckets if buckets is not None else SDXLBucketList()
        self.batch_size = batch_size
        self.image_key = image_key
        self.caption_key = caption_key
        self.resolution_key = resolution_key
        self.aspect_key = aspect_key
        self.clamp_orig = clamp_orig
        self.rng = np.random.default_rng(seed)
        self.bucket_idx: Optional[np.ndarray] = None
        super().__init__(**kwargs)

    def preload(self, force: bool = False) -> list:
        rows = super().preload(force)
        if rows and all("bucket_idx" in r for r in rows):
            self.bucket_idx = np.asarray([int(r["bucket_idx"]) for r in rows], np.int64)
        elif rows:
            self.bucket_idx = np.asarray([int(self.buckets.bucket_idx(float(r[self.aspect_key]))) for r in rows],
                                         np.int64)
        return rows

    def _item(self, index: int, rng: np.random.Generator) -> dict:
        row = self.samples[index]
        bucket = self.buckets[int(self.bucket_idx[index])]
        image = self._load_image(row[self.image_url_key])
        arr, fields = cropped_sample_fields(image, bucket=bucket, rng=rng, clamp_orig=self.clamp_orig)
        sample = {self.image_key: arr, self.caption_key: str(row[self.caption_key]), **fields}
        return self._apply_transforms(sample, row)

    def get_batch_iterator(self) -> Generator[list[int], None, None]:
        """Same-bucket batch schedule (aspect.py:200-232)."""
        return same_bucket_batches(self.bucket_idx, self.batch_size, self.rng)


class MongoSquareDataset(BaseMongoDataset):
    """Fixed-square Mongo dataset (mongo/nobucket.py:22-143): every sample
    cover-resized and random-cropped to ``resolution``, with its caption and
    SDXL's size conditionings."""

    def __init__(
        self,
        resolution: int = 256,
        batch_size: int = 1,
        image_key: str = "image",
        caption_key: str = "caption",
        clamp_orig: bool = True,
        seed: int = 0,
        **kwargs,
    ):
        self.resolution = (resolution, resolution) if isinstance(resolution, int) else tuple(resolution)
        self.batch_size = batch_size
        self.image_key = image_key
        self.caption_key = caption_key
        self.clamp_orig = clamp_orig
        self.rng = np.random.default_rng(seed)
        super().__init__(**kwargs)

    def _item(self, index: int, rng: np.random.Generator) -> dict:
        row = self.samples[index]
        image = self._load_image(row[self.image_url_key])
        arr, fields = cropped_sample_fields(image, resolution=self.resolution, rng=rng, clamp_orig=self.clamp_orig)
        sample = {self.image_key: arr, **fields}
        if self.caption_key is not None:
            sample[self.caption_key] = str(row[self.caption_key])
        return self._apply_transforms(sample, row)

    def get_batch_iterator(self) -> Generator[list[int], None, None]:
        """No buckets: shuffled fixed-size chunks (nobucket.py)."""
        return shuffled_chunk_batches(len(self.samples), self.batch_size, self.rng)


class MongoVAEDataset(MongoSquareDataset):
    """The square dataset without captions (mongo/nocaption.py:21-104)."""

    def __init__(self, **kwargs):
        kwargs.setdefault("caption_key", None)
        super().__init__(**kwargs)


class S3ImageLoader:
    """Parallel image fetcher of a blob store (dataset/loaders.py:22-148)."""

    def __init__(self, s3_endpoint: Optional[str] = None, max_workers: int = 16, retries: int = 5):
        self.s3_endpoint = s3_endpoint or os.environ.get("S3_ENDPOINT_URL")
        self.max_workers = max_workers
        self.retries = retries
        self._fs = None

    @property
    def fs(self):
        if self._fs is None:
            kwargs = {}
            if self.s3_endpoint:
                kwargs["client_kwargs"] = {"endpoint_url": self.s3_endpoint}
            self._fs = filesystem("s3", **kwargs)
        return self._fs

    def fetch(self, urls: Sequence[str]) -> dict[str, bytes]:
        """One multi-get; where it fails, each URL on a thread pool, a failed
        one dropped with a warning."""
        try:
            result = self.fs.cat(list(urls), on_error="omit")
        except Exception:  # noqa: BLE001 — the per-URL path below
            from concurrent.futures import ThreadPoolExecutor

            result = {}

            def one(u):
                try:
                    return u, self.fs.cat(u)
                except Exception as e:  # noqa: BLE001
                    logger.warning(f"drop {u}: {e}")
                    return u, None

            with ThreadPoolExecutor(self.max_workers) as ex:
                for u, b in ex.map(one, urls):
                    if b is not None:
                        result[u] = b
        return result
