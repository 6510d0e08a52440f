"""Pattern mining: the Python API over the port's C++ miner.

Port of ``dr4sr_tpu/regen/miner.py``. :func:`mine_patterns` finds the
ordered subsequences whose occurrences fit in a ``max_span`` window, with
support counted per sequence, keeping ``support >= min_frequency``;
:func:`match_pairs` pairs each sequence with up to ``max_matches`` patterns
that are subsequences of it. :func:`brute_force_patterns` and
:func:`is_sublist` are the plain versions the tests hold them against.

The library is host code, built from the port's own
``dr4sr_tpu_torch/cpp/seqminer.cpp`` at first use with ``g++ -O3
-march=native -fopenmp -shared -fPIC`` into the gitignored
``dr4sr_tpu_torch/_build/seqminer-<hash>.so``; the hash covers the source
and the flags, so an edited source rebuilds and an unchanged one loads at
once. Nothing builds at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from itertools import combinations
from typing import Dict, List, Sequence, Tuple

import numpy as np

from dr4sr_tpu_torch.ops import _build

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "cpp",
                      "seqminer.cpp")
GXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC")


def library_path() -> str:
    """``_build.BUILD_DIR/seqminer-<hash>.so``, the hash over flags and source."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(_build.BUILD_DIR, f"seqminer-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the miner unless its hashed library exists; return the path."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run(["g++", *GXX_FLAGS, SOURCE, "-o", tmp], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {SOURCE}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all of it or nothing
    return out


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(build())
    i64 = ctypes.c_int64
    p_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.mine_patterns.restype = i64
    lib.mine_patterns.argtypes = [p_i32, p_i64, i64, i64, i64, i64]
    lib.patterns_total_len.restype = i64
    lib.patterns_total_len.argtypes = []
    lib.get_patterns.restype = None
    lib.get_patterns.argtypes = [p_i32, p_i64, p_i64]
    lib.match_pairs.restype = i64
    lib.match_pairs.argtypes = [p_i32, p_i64, i64, p_i32, p_i64, i64, i64, ctypes.c_uint64, i64]
    lib.get_matches.restype = None
    lib.get_matches.argtypes = [p_i64, p_i64]
    return lib


def _to_csr(seqs: Sequence[Sequence[int]]) -> Tuple[np.ndarray, np.ndarray]:
    offsets = np.zeros(len(seqs) + 1, np.int64)
    offsets[1:] = np.cumsum([len(s) for s in seqs])
    flat = np.empty(offsets[-1], np.int32)
    for i, s in enumerate(seqs):
        flat[offsets[i] : offsets[i + 1]] = s
    return flat, offsets


def mine_patterns(
    sequences: Sequence[Sequence[int]],
    max_span: int = 5,
    min_frequency: int = 2,
    n_jobs: int = 0,
) -> Tuple[List[List[int]], List[int]]:
    """(patterns, frequencies), by frequency descending, then lexicographic.
    ``n_jobs`` OpenMP threads (0: all)."""
    lib = _lib()
    flat, offsets = _to_csr(sequences)
    n = lib.mine_patterns(flat, offsets, len(sequences), max_span, min_frequency, n_jobs)
    pat_flat = np.empty(lib.patterns_total_len(), np.int32)
    pat_offsets = np.empty(n + 1, np.int64)
    freqs = np.empty(n, np.int64)
    lib.get_patterns(pat_flat, pat_offsets, freqs)
    return [pat_flat[pat_offsets[i] : pat_offsets[i + 1]].tolist() for i in range(n)], freqs.tolist()


def match_pairs(
    sequences: Sequence[Sequence[int]],
    patterns: Sequence[Sequence[int]],
    max_matches: int = 10,
    seed: int = 2024,
    n_jobs: int = 0,
) -> List[List[int]]:
    """Per sequence, the indices of up to ``max_matches`` patterns that are
    subsequences of it, in a seeded random order."""
    lib = _lib()
    seq_flat, seq_offsets = _to_csr(sequences)
    pat_flat, pat_offsets = _to_csr(patterns)
    total = lib.match_pairs(seq_flat, seq_offsets, len(sequences), pat_flat, pat_offsets,
                            len(patterns), max_matches, seed, n_jobs)
    flat = np.empty(max(total, 1), np.int64)
    offsets = np.empty(len(sequences) + 1, np.int64)
    lib.get_matches(flat, offsets)
    return [flat[offsets[i] : offsets[i + 1]].tolist() for i in range(len(sequences))]


def brute_force_patterns(
    sequences: Sequence[Sequence[int]], max_span: int = 5, min_frequency: int = 2
) -> Dict[tuple, int]:
    """Every window subsequence, enumerated in Python: {pattern: support}."""
    counts: Dict[tuple, int] = {}
    for seq in sequences:
        seen = set()
        n = len(seq)
        for i in range(n - 1):
            w = min(max_span, n - i)
            tail = list(range(i + 1, i + w))
            for r in range(1, w):
                for combo in combinations(tail, r):
                    seen.add((seq[i],) + tuple(seq[j] for j in combo))
        for p in seen:
            counts[p] = counts.get(p, 0) + 1
    return {p: c for p, c in counts.items() if c >= min_frequency}


def is_sublist(sub: Sequence[int], lst: Sequence[int]) -> bool:
    """Greedy subsequence check (the reference's ``is_sublist``)."""
    it = iter(lst)
    return all(any(x == y for y in it) for x in sub)
