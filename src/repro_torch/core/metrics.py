"""Streaming percentile metrics for fleet-scale replay.

A fleet replay runs thousands of seeds x 10^4-10^5 steps; keeping
per-step traces would cost O(T x B x F), so the distribution metrics
ride the engine's state instead:

* **Fixed-bin log-spaced histograms** for queue delay and flow
  completion time (FCT): :data:`NBINS` bins over :data:`DECADES` decades
  from ``10**LOG10_MIN`` seconds, :data:`BINS_PER_DECADE` a decade. Any
  quantile read from one is exact up to a bin's width (a factor of
  ``10**(1/BINS_PER_DECADE)``, about 1.33); values below or above the
  span clamp into the first or last bin.
* **Welford accumulators** (count, mean, M2) per job over the slowdown
  of each completion, merged each step with Chan's parallel update.

Both updates are sums in a fixed order, with no float atomics
(``index_add_`` or a float ``scatter_add_`` would use them on the card):

* :func:`hist_add` takes weights of 0 or 1 (the engine's ``active`` and
  ``done x fct_mask``, ``fct_mask`` being 0/1). A step's count in each
  (cell, bin) is formed first as an integer (an int64 ``scatter_add_``:
  integer adds, exact in any order, and no device-to-host sync, which
  ``torch.bincount`` makes on the card), then added to the histogram, so
  it is exact in float32 whatever the order while a bin stays below
  2^24. Past that, float32 rounds the sum, and the reference's
  sample-by-sample scatter may then differ from the port's
  count-then-add in the last bits of that bin.
* :func:`welford_update` sums each group's ``w``, ``w * sample`` and
  ``w * (sample - mean)**2`` over its members as a pairwise tree over a
  member table padded to a power of two (:func:`simulator.source_table`
  and :func:`simulator.source_sums`, keyed on the flow's job). It
  differs from the reference's sequential ``.at[].add`` only in the last
  bits of a group's sums; a group with zero batch weight is left bit for
  bit as it was.

:func:`bin_index` is shared by the streaming and the post-hoc path, so
binning the same samples after the fact with :func:`np_hist` reproduces
the streaming histogram bin for bin. Host-side extraction
(:func:`percentiles`, :func:`hist_cdf`, :func:`welford_finalize`) is
NumPy, as in the reference.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

NBINS = 64
BINS_PER_DECADE = 8
DECADES = NBINS // BINS_PER_DECADE  # 8 decades
LOG10_MIN = -7.0  # first bin edge: 100 ns
_FLOOR = 1e-30  # log argument floor; maps 0.0 into the first bin

# default quantiles of a replay's summary
QUANTILES = (0.50, 0.90, 0.99, 0.999)


def bin_edges() -> np.ndarray:
    """(NBINS + 1,) bin edges in seconds, log-spaced."""
    return 10.0 ** (LOG10_MIN + np.arange(NBINS + 1) / BINS_PER_DECADE)


def bin_index(x):
    """Bin id of each sample (seconds), float32 arithmetic: a tensor in,
    an int64 tensor out; anything else in, an int32 numpy array out."""
    if isinstance(x, torch.Tensor):
        lg = torch.log10(torch.clamp_min(x.to(torch.float32), _FLOOR))
        idx = torch.floor((lg - LOG10_MIN) * BINS_PER_DECADE)
        return torch.clamp(idx, 0, NBINS - 1).to(torch.int64)
    lg = np.log10(np.maximum(np.asarray(x, np.float32), np.float32(_FLOOR)))
    idx = np.floor((lg - np.float32(LOG10_MIN)) * np.float32(BINS_PER_DECADE))
    return np.clip(idx, 0, NBINS - 1).astype(np.int32)


def hist_add(h: torch.Tensor, x: torch.Tensor,
             w: torch.Tensor) -> torch.Tensor:
    """Add the samples ``x`` (..., F) of weight ``w`` (..., F), each 0 or
    1, to the histograms ``h`` (..., NBINS): each histogram's count per
    bin is formed as an integer, then added (see the module docstring)."""
    lead = x.shape[:-1]
    n = math.prod(lead)
    bins = torch.where(w != 0, bin_index(x), NBINS)  # NBINS: not counted
    off = torch.arange(n, device=x.device).view(*lead, 1) * (NBINS + 1)
    idx = (bins + off).reshape(-1)
    counts = torch.zeros(n * (NBINS + 1), dtype=torch.int64,
                         device=x.device)
    counts.scatter_add_(0, idx, torch.ones_like(idx))
    return h + counts.view(*lead, NBINS + 1)[..., :NBINS].to(h.dtype)


def np_hist(x, w=None) -> np.ndarray:
    """Post-hoc histogram over materialized samples: the oracle of the
    streaming path."""
    x = np.asarray(x, np.float32).ravel()
    w = np.ones_like(x) if w is None else np.asarray(w, np.float32).ravel()
    h = np.zeros((NBINS,), np.float64)
    np.add.at(h, bin_index(x).ravel(), w)
    return h.astype(np.float32)


def welford_update(wn, wmean, wm2, sample, weight, seg_ids, table):
    """Merge one step's samples into per-group Welford accumulators
    (Chan's parallel update). ``wn``/``wmean``/``wm2`` are (B, G);
    ``sample``/``weight`` (B, F); ``seg_ids`` (R, F) is each sample's
    group and ``table`` (R, G, W) its member table
    (:func:`simulator.source_table` of ``seg_ids``), R = 1 or B. A group
    with zero batch weight is left exactly unchanged."""
    from repro_torch.core.fabric.simulator import source_sums

    w = weight.to(torch.float32)
    nb, sum_b = source_sums(torch.stack([w, w * sample], 1), table).unbind(1)
    mean_b = sum_b / torch.clamp_min(nb, 1.0)
    dev = sample - mean_b.gather(1, seg_ids.expand(sample.shape))
    m2_b = source_sums(w * dev ** 2, table)
    n_new = wn + nb
    delta = mean_b - wmean
    frac = nb / torch.clamp_min(n_new, 1.0)
    return n_new, wmean + delta * frac, wm2 + m2_b + delta * delta * wn * frac


def welford_finalize(wn, wmean, wm2):
    """(count, mean, std) from accumulators; NaN mean/std where count==0."""
    wn = np.asarray(wn, np.float64)
    empty = wn <= 0
    mean = np.where(empty, np.nan, np.asarray(wmean, np.float64))
    var = np.asarray(wm2, np.float64) / np.maximum(wn, 1.0)
    std = np.where(empty, np.nan, np.sqrt(np.maximum(var, 0.0)))
    return wn, mean, std


def percentiles(h: np.ndarray, qs: Sequence[float] = QUANTILES) -> dict:
    """Quantiles read from a histogram: the geometric midpoint of the
    first bin whose cumulative weight reaches ``q`` of the total. Exact
    up to one bin width. Empty histogram -> NaN. Batched histograms
    (.., NBINS) return arrays over the leading axes."""
    h = np.asarray(h, np.float64)
    edges = bin_edges()
    mids = np.sqrt(edges[:-1] * edges[1:])
    cdf = np.cumsum(h, axis=-1)
    total = cdf[..., -1:]
    out = {}
    for q in qs:
        hit = cdf >= np.maximum(q * total, _FLOOR)
        idx = np.argmax(hit, axis=-1)
        out[q] = np.where(total[..., 0] > 0, mids[idx], np.nan)
    return out


def hist_cdf(h: np.ndarray):
    """(upper_edges, cdf in [0,1]) for plotting FCT / delay CDFs."""
    h = np.asarray(h, np.float64)
    cdf = np.cumsum(h, axis=-1)
    total = np.maximum(cdf[..., -1:], _FLOOR)
    return bin_edges()[1:], cdf / total
