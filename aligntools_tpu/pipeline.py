"""Batch pipeline: many-pair FASTA -> bucketed device batches -> TSV results.

The throughput surface the reference lacks entirely (it processes exactly
one pair per process, alignment.h:217-262): a multi-record FASTA/Q (gz ok)
is read with the native parser, consecutive records pair up (q1,t1,q2,t2,
...), pairs are aligned in chunks on the device (batch.py bucketing +
hybrid engine routing; optionally dp-sharded over a mesh), and results
stream out as TSV:

    name1  name2  score  [row1  row2]

Aux subsystems (SURVEY.md §5 equivalents, all new):
  * checkpoint/resume — chunk manifest (utils/checkpoint.py), chunk-atomic
    output appends;
  * observability — GCUPS/pairs-per-sec counters and optional
    jax.profiler trace (utils/profiling.py);
  * fit junction support — per-pair sites parsed from each target
    record's header comment, as the reference's ``-s`` does for its one
    pair (alignment.h:243-256).
"""

from __future__ import annotations

import os
import sys
import time as _time

from aligntools_tpu.io.fasta import parse_junctions, read_records
from aligntools_tpu.params import AlignParams
from aligntools_tpu.utils.checkpoint import Manifest
from aligntools_tpu.utils.profiling import Counters, device_trace, stopwatch


def read_pair_records(path: str):
    """All records; consecutive records pair (q, t). Odd counts are an
    error (a dangling query with no target)."""
    records = list(read_records(path))
    if len(records) % 2:
        raise ValueError(
            f"{path}: {len(records)} records — batch input must pair up "
            f"(query, target) consecutively"
        )
    return [(records[i], records[i + 1]) for i in range(0, len(records), 2)]


def chunk_bounds(n: int, chunk_size: int) -> list[tuple[int, int]]:
    """[lo, hi) of ceil(n / chunk_size) chunks of near-equal size, none
    above ``chunk_size``: equal chunks hold similar bucket occupancies,
    so padding every chunk to the largest one costs few rows."""
    k = -(-n // chunk_size)
    cuts = [n * i // k for i in range(k + 1)] if k else [0]
    return list(zip(cuts[:-1], cuts[1:]))


def run_pipeline(
    mode: str,
    path: str,
    params: AlignParams = AlignParams(),
    *,
    use_sites: bool = False,
    scores_only: bool = False,
    sharded: bool = False,
    chunk_size: int = 16384,
    manifest_path: str | None = None,
    out=None,
    out_path: str | None = None,
    trace_dir: str | None = None,
    engine: str = "auto",
    cigar: bool = False,
    band: int | None = None,
) -> Counters:
    """Align every pair in ``path``; returns run counters.

    ``out_path`` makes the pipeline own the output file: with a manifest,
    each chunk's end byte offset is checkpointed and a resumed run
    truncates any torn chunk back to the last completed watermark before
    appending — crash-atomic resume. With a caller-provided ``out`` stream
    instead, chunk skipping still works but a kill between the chunk write
    and the manifest update re-emits that chunk.
    """
    from aligntools_tpu.batch import align_batch, batch_scores

    from aligntools_tpu.backend import enable_compile_cache, require_device

    require_device()
    enable_compile_cache()
    if out is not None and out_path is not None:
        raise ValueError("pass out or out_path, not both")
    own_out = out_path is not None
    if own_out:
        # Binary: tell()/truncate() must be real byte offsets for the
        # manifest watermark. r+b keeps completed chunks for resume.
        out = open(out_path, "r+b" if os.path.exists(out_path) else "w+b")
    else:
        out = out or sys.stdout
    counters = Counters()
    with stopwatch(counters, "io_seconds"):
        rec_pairs = read_pair_records(path)
    if mode != "fit" and use_sites:
        raise ValueError("junction sites are only meaningful in fit mode")
    if band is not None and use_sites:
        raise ValueError("--band does not support the fit jump state")
    if band is not None and sharded:
        # compute() routes sharded FIRST; silently ignoring --band there
        # would report unbanded scores as banded ones
        raise ValueError("--band does not support --sharded")

    manifest = None
    if manifest_path:
        manifest = Manifest.load_or_create(
            manifest_path, os.path.abspath(path), mode, chunk_size,
            len(rec_pairs),
        )
    if own_out:
        if manifest:
            wm = manifest.watermark()
            out.seek(wm)
            out.truncate(wm)  # drop any torn chunk from a killed run
        else:
            out.seek(0)
            out.truncate(0)

    bounds = chunk_bounds(len(rec_pairs), chunk_size)
    chunks = [rec_pairs[lo:hi] for lo, hi in bounds]

    # ONE global bucket partition for the whole run: per-chunk greedy
    # partitions drift with the data (measured: 779 distinct compiled
    # (B, m_pad, n_pad) fill keys on a 100k-pair run at chunk 4096), so
    # every chunk is bucketed with the same global shape keys, and each
    # shape runs at its largest per-chunk occupancy in every chunk, so
    # all chunks share one compiled batch rung per shape.
    global_keys = batch_rows = None
    if band is None and not sharded:
        from collections import Counter

        from aligntools_tpu.batch import _bucket_keys

        with stopwatch(counters, "encode_seconds"):
            global_keys = _bucket_keys(
                [(a.seq, b.seq) for a, b in rec_pairs], 64, 128
            )
            batch_rows = {}
            for lo, hi in bounds:
                for key, c in Counter(global_keys[lo:hi]).items():
                    batch_rows[key] = max(batch_rows.get(key, 0), c)

    def compute(ci, chunk):
        """Align one chunk (runs on the prefetch worker: the NEXT chunk's
        encode + device fill overlaps the main thread's formatting and
        writing of the previous chunk's results)."""
        keys = None
        if global_keys is not None:
            lo = bounds[ci][0]
            keys = global_keys[lo : lo + len(chunk)]
        pairs = [(a.seq, b.seq) for a, b in chunk]
        sites_list = None
        if use_sites:
            sites_list = [
                parse_junctions(b.comment) if b.comment else []
                for _, b in chunk
            ]
        if sharded or band is not None:
            route = "sharded" if sharded else "banded"
            counters.routes[route] = counters.routes.get(route, 0) + 1
        if sharded:
            from aligntools_tpu.parallel.mesh import batch_scores_sharded

            return pairs, list(batch_scores_sharded(mode, pairs, params))
        if band is not None:
            if scores_only or mode == "edit":
                from aligntools_tpu.engine.banded import banded_batch_scores

                return pairs, list(
                    banded_batch_scores(mode, pairs, band, params)[0]
                )
            from aligntools_tpu.engine.banded import banded_align_batch

            return pairs, banded_align_batch(mode, pairs, band, params)[0]
        if mode == "edit" or scores_only:
            return pairs, list(
                batch_scores(mode, pairs, params, sites_list,
                             engine=engine, counters=counters, keys=keys,
                             batch_rows=batch_rows)
            )
        return pairs, align_batch(
            mode, pairs, params, sites_list, traceback=True,
            counters=counters, keys=keys, batch_rows=batch_rows,
        )

    pending = [
        (ci, chunk)
        for ci, chunk in enumerate(chunks)
        if not (manifest and manifest.is_done(ci))
    ]
    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(1)
    try:
        with device_trace(trace_dir), stopwatch(counters, "seconds"):
            fut = pool.submit(compute, *pending[0]) if pending else None
            for pi, (ci, chunk) in enumerate(pending):
                pairs, results = fut.result()
                if pi + 1 < len(pending):
                    fut = pool.submit(compute, *pending[pi + 1])
                tfmt = _time.perf_counter()
                lines = []
                for k, ((a, b), r) in enumerate(zip(chunk, results)):
                    name1 = a.name.decode("latin-1")
                    name2 = b.name.decode("latin-1")
                    if mode == "edit":
                        lines.append(f"{name1}\t{name2}\t{int(r)}")
                    elif scores_only or sharded:
                        score = r if isinstance(r, float) else float(r)
                        lines.append(f"{name1}\t{name2}\t{score:.6f}")
                    elif cigar:
                        from aligntools_tpu.utils.cigar import rows_to_cigar

                        lines.append(
                            f"{name1}\t{name2}\t{r.score:.6f}\t"
                            f"{rows_to_cigar(r.row1, r.row2)}"
                        )
                    else:
                        lines.append(
                            f"{name1}\t{name2}\t{r.score:.6f}\t"
                            f"{r.row1.decode('latin-1')}\t"
                            f"{r.row2.decode('latin-1')}"
                        )
                    counters.pairs += 1
                    counters.cells += len(pairs[k][0]) * len(pairs[k][1])
                if sharded:
                    # batch_scores_sharded doesn't thread counters; the
                    # unsharded paths account executed padded cells
                    # (incl. batch-rung rows) inside align_batch
                    # (sharded+band is rejected upfront)
                    from aligntools_tpu.batch import _bucket_keys

                    counters.padded_cells += sum(
                        mp * np_ for mp, np_ in _bucket_keys(pairs, 64, 128)
                    )
                text = "\n".join(lines) + "\n"
                out.write(text.encode("latin-1") if own_out else text)
                if hasattr(out, "flush"):
                    out.flush()
                if own_out:
                    os.fsync(out.fileno())  # durable before manifest says done
                if manifest:
                    manifest.mark_done(ci, out.tell() if own_out else None)
                counters.format_seconds += _time.perf_counter() - tfmt
    finally:
        pool.shutdown(wait=False, cancel_futures=True)
    if own_out:
        out.close()
    return counters
