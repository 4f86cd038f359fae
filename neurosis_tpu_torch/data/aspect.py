"""Aspect-ratio bucketing (port of neurosis_tpu/data/aspect.py; parity:
dataset/aspect/bucket.py:20-231, lists.py:4-176).

Constraint-driven bucket synthesis and the fixed SDXL/WDXL tables; a batch
comes from one bucket, so its images share one shape.
"""

from __future__ import annotations

import math
from bisect import bisect_left
from dataclasses import dataclass, field
from itertools import product
from typing import Optional, Sequence

import numpy as np

from .utils import cover_resize


def percent_diff(v1: int, v2: int) -> float:
    return round((v1 - v2) / ((v1 + v2) / 2) * 100, 2)


@dataclass(frozen=True)
class AspectBucket:
    """A (width, height) training resolution; multiples of 32 (bucket.py:20-77)."""

    width: int
    height: int
    square_px: Optional[int] = field(default=None, compare=False)

    def __post_init__(self):
        if self.width % 32 != 0 or self.height % 32 != 0:
            raise ValueError(f"width/height must be multiples of 32, got {self.width}x{self.height}")

    @property
    def aspect(self) -> float:
        return round(self.width / self.height, 4)

    @property
    def pixels(self) -> int:
        return self.width * self.height

    @property
    def error(self) -> Optional[float]:
        return percent_diff(self.pixels, self.square_px**2) if self.square_px else None

    @property
    def shape(self) -> tuple[int, int, int]:
        return (self.height, self.width, 3)

    @property
    def size(self) -> tuple[int, int]:
        return (self.width, self.height)

    def flipped(self) -> "AspectBucket":
        # reference drops square_px on flip (bucket.py:62-64)
        return AspectBucket(self.height, self.width, None)

    def resize(self, image: np.ndarray) -> np.ndarray:
        """Cover-resize RGB uint8 HWC pixels to this bucket
        (``ImageOps.cover(..., BICUBIC)``, pixel for pixel)."""
        return cover_resize(image, self.size)


def _select_by_px(buckets: list, alt: bool = False) -> AspectBucket:
    if len(buckets) > 1:
        buckets = sorted(buckets, key=lambda x: x.pixels)
        return buckets[-2] if alt else buckets[-1]
    if len(buckets) == 1:
        return buckets[0]
    raise ValueError("Cannot select from empty list of buckets")


class AspectBucketList:
    """Bucket list generated from constraints (bucket.py:80-231)."""

    _data: Optional[list] = None  # predefined by subclasses

    def __init__(
        self,
        n_buckets: int = 25,
        edge_min: int = 512,
        edge_max: int = 1536,
        edge_step: int = 64,
        max_aspect: float = 2.5,
        tgt_pixels: int = 1024 * 1024,
        tolerance: float = 5,
        bias_square: bool = True,
        use_atan: bool = False,
        data: Optional[Sequence[AspectBucket]] = None,
    ):
        if not 1 <= n_buckets <= 100:
            raise ValueError(f"n_buckets must be in [1, 100], got {n_buckets}")
        if edge_min < edge_step or edge_min > edge_max:
            raise ValueError(f"edge_min must be in [edge_step, edge_max], got {edge_min}")
        if edge_max > 4096:
            raise ValueError(f"edge_max must be <= 4096, got {edge_max}")
        if edge_max % edge_step or edge_min % edge_step:
            raise ValueError("edge_min/edge_max must be multiples of edge_step")
        if edge_max // edge_min < max_aspect:
            raise ValueError("max_aspect must be <= edge_max / edge_min")

        self.n_buckets = n_buckets
        self.edge_min = edge_min
        self.edge_max = edge_max
        self.edge_step = edge_step
        self.max_aspect = max_aspect if max_aspect > 0.0 else float("inf")
        self.max_pixels = int(tgt_pixels * (1.0 + tolerance / 100))
        self.min_pixels = int(tgt_pixels * (1.0 - tolerance / 100))
        self.bias_square = bias_square
        self.use_atan = use_atan
        sq = math.sqrt(tgt_pixels)
        self._square_px = int(sq) if sq.is_integer() else None

        self.data: list[AspectBucket] = list(data) if data is not None else self._generate()

    # -- generation (bucket.py:124-187) -----------------------------------

    def _generate(self) -> list[AspectBucket]:
        edges = range(self.edge_min, self.edge_max + 1, self.edge_step)
        valid = [
            AspectBucket(x, y, self._square_px)
            for x, y in product(edges, edges)
            if x >= y and self.min_pixels <= x * y <= self.max_pixels and x / y <= self.max_aspect
        ]

        by_aspect: dict[float, list[AspectBucket]] = {}
        for b in valid:
            by_aspect.setdefault(round(b.aspect, 2), []).append(b)

        unique = sorted((_select_by_px(v) for v in by_aspect.values()), key=lambda b: b.aspect)
        if len(unique) < self.n_buckets:
            unique.extend(
                sorted((_select_by_px(v, alt=True) for v in by_aspect.values()), key=lambda b: b.aspect)
            )
            if len(unique) < self.n_buckets:
                raise ValueError(
                    f"{self.n_buckets} buckets requested but only {len(unique)} generated; "
                    "reduce edge_step/edge_min or increase edge_max"
                )

        split = int(np.clip((self.n_buckets + 1) // 2, 1, len(unique)))
        idxs = np.linspace(0, len(unique) - 1, split, dtype=int).tolist()
        # dedup keyed on (w, h, square_px or 0) — the reference's hash
        # (bucket.py:58-59). Quirk preserved: the square bucket appears twice
        # (original has square_px set, its flip has None), which shifts
        # bucket_idx for all landscape ratios.
        chosen = {}
        for i in idxs:
            for b in (unique[i], unique[i].flipped()):
                chosen.setdefault((b.width, b.height, b.square_px or 0), b)
        return sorted(chosen.values(), key=lambda b: b.aspect)

    # -- lookup (bucket.py:190-231) ----------------------------------------

    def bucket_idx(self, ratio: float) -> int:
        if ratio < 0.0:
            raise ValueError(f"ratio must be > 0, got {ratio}")
        return self._lookup(ratio)

    def bucket(self, ratio: float) -> AspectBucket:
        return self.data[self.bucket_idx(ratio)]

    def _lookup(self, ratio: float) -> int:
        if ratio == 1.0:
            return self.ratios.index(1.0)
        find = np.arctan(ratio) if self.use_atan else ratio
        aspects = self.arctans if self.use_atan else self.ratios
        if self.bias_square:
            idx = bisect_left(aspects, find)
            if ratio > 1.0:
                idx -= 1
            return int(np.clip(idx, 0, len(self.data) - 1))
        return int(np.interp(find, aspects, list(range(len(aspects)))).round())

    @property
    def ratios(self) -> list[float]:
        return [b.aspect for b in self.data]

    @property
    def arctans(self) -> list[float]:
        return [float(np.arctan(b.aspect)) for b in self.data]

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, i):
        return self.data[i]

    def __iter__(self):
        return iter(self.data)


def _predefined(dims: Sequence[tuple[int, int]], train_res: int, **kwargs) -> dict:
    data = [AspectBucket(w, h, train_res) for w, h in dims]
    return dict(
        n_buckets=len(data),
        edge_min=512,
        edge_max=2048,
        edge_step=64,
        max_aspect=4.0,
        tgt_pixels=train_res**2,
        data=data,
        **kwargs,
    )


_SDXL_DIMS = [
    (512, 2048), (512, 1984), (512, 1920), (512, 1856), (576, 1792), (576, 1728),
    (576, 1664), (640, 1600), (640, 1536), (704, 1472), (704, 1408), (704, 1344),
    (768, 1344), (768, 1280), (832, 1216), (832, 1152), (896, 1152), (896, 1088),
    (960, 1088), (960, 1024), (1024, 1024), (1024, 960), (1088, 960), (1088, 896),
    (1152, 896), (1152, 832), (1216, 832), (1280, 768), (1344, 768), (1408, 704),
    (1472, 704), (1536, 640), (1600, 640), (1664, 576), (1728, 576), (1792, 576),
    (1856, 512), (1920, 512), (1984, 512), (2048, 512),
]

_WDXL_DIMS = [
    (512, 2048), (512, 1984), (576, 1920), (576, 1792), (576, 1728), (704, 1472),
    (768, 1408), (768, 1344), (832, 1280), (896, 1216), (896, 1152), (960, 1152),
    (960, 1088), (1024, 1024), (1088, 960), (1152, 960), (1152, 896), (1216, 896),
    (1280, 832), (1344, 768), (1408, 768), (1472, 704),
]

_WDXL2_DIMS = [
    (512, 2048), (512, 1984), (576, 1920), (576, 1856), (576, 1792), (576, 1728),
    (640, 1664), (640, 1600), (640, 1536), (704, 1536), (704, 1472), (768, 1408),
    (768, 1344), (832, 1280), (832, 1216), (896, 1152), (960, 1088), (1024, 1024),
    (1088, 960), (1152, 896), (1216, 832), (1280, 832), (1344, 768), (1408, 768),
    (1472, 704), (1536, 704), (1536, 640), (1600, 640), (1664, 640), (1728, 576),
    (1792, 576), (1856, 576), (1920, 576), (1984, 512), (2048, 512),
]


class SDXLBucketList(AspectBucketList):
    """Original SDXL training buckets (lists.py:4-67)."""

    def __init__(self, bias_square: bool = True, use_atan: bool = False):
        super().__init__(
            tolerance=5, bias_square=bias_square, use_atan=use_atan, **_predefined(_SDXL_DIMS, 1024)
        )


class WDXLBucketList(AspectBucketList):
    """WDXL training buckets (lists.py:70-116)."""

    def __init__(self, bias_square: bool = True, use_atan: bool = False):
        super().__init__(
            tolerance=5, bias_square=bias_square, use_atan=use_atan, **_predefined(_WDXL_DIMS, 1024)
        )


class WDXLBucketList2(AspectBucketList):
    """WDV training buckets (lists.py:118-176)."""

    def __init__(self, bias_square: bool = True, use_atan: bool = False):
        super().__init__(
            tolerance=7, bias_square=bias_square, use_atan=use_atan, **_predefined(_WDXL2_DIMS, 1024)
        )
