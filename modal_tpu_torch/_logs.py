"""Client-side logs: historical backfill + live tail (port of
modal_tpu/_logs.py).

Reference: py/modal/_logs.py — `fetch_logs` (bucketed historical fetch,
_logs.py:114-310) and `tail_logs`; _logs_manager.py follow state machines.
Here: `fetch_app_logs` pages AppFetchLogs over the stored history (with
time/task filters) and `stream_app_logs` long-polls the live tail; the CLI's
`app logs` chains the two (backfill → follow)."""

from __future__ import annotations

import asyncio
import sys
from typing import AsyncGenerator, Optional, TextIO

from ._utils.grpc_utils import retry_transient_errors
from .client import _Client
from .config import logger
from .proto import api_pb2


async def fetch_app_logs(
    client: _Client,
    app_id: str,
    *,
    min_timestamp: float = 0.0,
    max_timestamp: float = 0.0,
    task_id: str = "",
    final_index: Optional[list] = None,
    start_index: int = 0,
) -> AsyncGenerator[api_pb2.TaskLogs, None]:
    """Page through the app's stored log history (backfill). Pass a list as
    `final_index` to receive the end cursor (for a follow handoff);
    `start_index` seeks past entries known to precede the window (the
    bucketed path supplies it from the histogram)."""
    index = start_index
    while True:
        resp = await retry_transient_errors(
            client.stub.AppFetchLogs,
            api_pb2.AppFetchLogsRequest(
                app_id=app_id,
                start_index=index,
                min_timestamp=min_timestamp,
                max_timestamp=max_timestamp,
                task_id=task_id,
            ),
        )
        for entry in resp.entries:
            yield entry
        done = resp.next_index <= index or resp.next_index >= resp.total
        index = max(index, resp.next_index)
        if done:
            break
    if final_index is not None:
        final_index.append(index)


# bucketed-backfill tuning (reference _logs.py:114-310): buckets denser than
# REFINE_THRESHOLD entries are recursively re-counted with finer buckets so
# each final fetch interval is roughly one page
REFINE_THRESHOLD = 500
MAX_REFINE_DEPTH = 4
N_BUCKETS = 16


async def build_fetch_intervals(
    client: _Client,
    app_id: str,
    min_timestamp: float,
    max_timestamp: float,
    task_id: str = "",
    _depth: int = 0,
) -> list[tuple[float, float]]:
    """AppCountLogs histogram → list of (start, end) time intervals covering
    every stored entry in range, skipping empty spans and splitting dense
    ones (reference _build_fetch_intervals, _logs.py:142)."""
    resp = await retry_transient_errors(
        client.stub.AppCountLogs,
        api_pb2.AppCountLogsRequest(
            app_id=app_id,
            min_timestamp=min_timestamp,
            max_timestamp=max_timestamp,
            n_buckets=N_BUCKETS,
            task_id=task_id,
        ),
    )
    intervals: list[tuple[float, float, int]] = []  # (start, end, start_index)
    for bucket in resp.buckets:
        if bucket.count == 0:
            continue
        if bucket.count > REFINE_THRESHOLD and _depth < MAX_REFINE_DEPTH:
            intervals.extend(
                await build_fetch_intervals(
                    client, app_id, bucket.start, bucket.end, task_id, _depth + 1
                )
            )
        else:
            intervals.append((bucket.start, bucket.end, bucket.start_index))
    # merge adjacent intervals so one fetch covers a contiguous dense range
    # (keeping the earliest start_index — the seek offset for the fetch)
    merged: list[tuple[float, float, int]] = []
    for start, end, idx in intervals:
        if merged and abs(merged[-1][1] - start) < 1e-9:
            merged[-1] = (merged[-1][0], end, min(merged[-1][2], idx))
        else:
            merged.append((start, end, idx))
    return merged


async def fetch_app_logs_bucketed(
    client: _Client,
    app_id: str,
    *,
    min_timestamp: float = 0.0,
    max_timestamp: float = 0.0,
    task_id: str = "",
) -> AsyncGenerator[api_pb2.TaskLogs, None]:
    """Time-windowed backfill that only pages the dense ranges the histogram
    found — on a long-lived app with a narrow window this touches a fraction
    of the history a flat scan would."""
    intervals = await build_fetch_intervals(client, app_id, min_timestamp, max_timestamp, task_id)
    for start, end, start_index in intervals:
        async for entry in fetch_app_logs(
            client,
            app_id,
            min_timestamp=start,
            max_timestamp=end,
            task_id=task_id,
            start_index=start_index,
        ):
            yield entry


async def print_app_logs(
    client: _Client,
    app_id: str,
    out: Optional[TextIO] = None,
    *,
    follow: bool = False,
    task_id: str = "",
    min_timestamp: float = 0.0,
    max_timestamp: float = 0.0,
) -> None:
    """Backfill the stored history, then optionally follow the live tail.
    With a time window (and no follow handoff needed), the bucketed path
    pages only the dense ranges the AppCountLogs histogram found."""
    out = out or sys.stdout
    end_cursor: list = []
    if (min_timestamp or max_timestamp) and not follow:
        entries = fetch_app_logs_bucketed(
            client, app_id, min_timestamp=min_timestamp, max_timestamp=max_timestamp, task_id=task_id
        )
    else:
        entries = fetch_app_logs(
            client,
            app_id,
            task_id=task_id,
            min_timestamp=min_timestamp,
            max_timestamp=max_timestamp,
            final_index=end_cursor,
        )
    async for entry in entries:
        text = entry.data
        if text:
            out.write(text if text.endswith("\n") else text + "\n")
    out.flush()
    if follow:
        # live tail resumes from the backfill's end (entry ids are indices)
        await stream_app_logs(
            client,
            app_id,
            out,
            stop_on_app_done=True,
            start_entry_id=str(end_cursor[0]) if end_cursor else "",
            task_id=task_id,
        )


async def stream_app_logs(
    client: _Client,
    app_id: str,
    out: Optional[TextIO] = None,
    stop_on_app_done: bool = True,
    start_entry_id: str = "",
    task_id: str = "",
) -> None:
    """Tail an app's logs until cancelled or the app finishes."""
    out = out or sys.stdout
    last_entry_id = start_entry_id
    while True:
        try:
            async for batch in client.stub.AppGetLogs(
                api_pb2.AppGetLogsRequest(
                    app_id=app_id, timeout=30.0, last_entry_id=last_entry_id, task_id=task_id
                )
            ):
                last_entry_id = batch.entry_id or last_entry_id
                for item in batch.items:
                    text = item.data
                    if text:
                        out.write(text if text.endswith("\n") else text + "\n")
                        out.flush()
                if batch.app_done and stop_on_app_done:
                    return
        except asyncio.CancelledError:
            raise
        except Exception as exc:
            logger.debug(f"log stream interrupted: {exc}; resuming")
            await asyncio.sleep(0.5)
