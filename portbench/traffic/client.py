"""The open-loop HTTP client: sends each request of a schedule at its due
time whether or not earlier ones have finished, on one asyncio thread, and
times it from its due time until its response has been read.

Run as ``python -m portbench.traffic.client``: it reads one JSON object
(the server's host and port, the schedule, the indices whose images to
keep, the time limit after the window) from standard input, waits for a
line ``go``, runs the schedule and prints one JSON object of results."""

from __future__ import annotations

import asyncio
import json
import sys
import time


async def _one(host: str, port: int, label: int, due: float, keep: bool) -> dict:
    await asyncio.sleep(max(0.0, due - time.perf_counter()))
    sent = time.perf_counter()
    body = json.dumps({"label": int(label), "count": 1}).encode()
    try:
        reader, writer = await asyncio.open_connection(host, port)
        writer.write(b"POST /generate HTTP/1.1\r\nHost: localhost\r\nContent-Type: application/json\r\n"
                     b"Connection: close\r\nContent-Length: %d\r\n\r\n" % len(body) + body)
        await writer.drain()
        data = await reader.read()
        writer.close()
    except OSError as e:  # refused, reset: failed, with the time waited until then
        return {"ok": False, "latency_s": time.perf_counter() - due, "late_s": sent - due,
                "error": f"{type(e).__name__}: {e}"}
    done = time.perf_counter()
    head, _, payload = data.partition(b"\r\n\r\n")
    ok = head.split(b" ", 2)[1:2] == [b"200"]
    out = {"ok": ok, "latency_s": done - due, "late_s": sent - due}
    if not ok:
        out["error"] = payload[:200].decode(errors="replace")
    elif keep:
        out["png_b64"] = json.loads(payload)["images"][0]
    return out


async def _run(spec: dict, t0: float) -> list[dict]:
    keep = set(spec["keep"])
    tasks = [asyncio.ensure_future(_one(spec["host"], spec["port"], label, t0 + off, i in keep))
             for i, (off, label) in enumerate(zip(spec["offsets"], spec["labels"]))]
    deadline = t0 + max(spec["offsets"], default=0.0) + spec["limit_after_s"]
    done, pending = await asyncio.wait(tasks, timeout=max(0.0, deadline - time.perf_counter()))
    for t in pending:
        t.cancel()
    await asyncio.gather(*pending, return_exceptions=True)
    return [t.result() if t in done else {"ok": False, "error": "no answer within the time limit",
                                          "latency_s": time.perf_counter() - t0 - off}
            for t, off in zip(tasks, spec["offsets"])]


def run_schedule(spec: dict) -> list[dict]:
    """Run a schedule now (``offsets`` in seconds from its start)."""
    return asyncio.run(_run(spec, time.perf_counter()))


def main() -> int:
    spec = json.loads(sys.stdin.readline())
    if sys.stdin.readline().strip() != "go":
        return 1
    print(json.dumps(run_schedule(spec)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
