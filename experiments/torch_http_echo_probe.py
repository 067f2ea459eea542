#!/usr/bin/env python3
"""http_echo_probe.py on the PyTorch port: the HTTP layer alone. The port's
FastHTTPFrontend (serve/fastloop.py) in front of a stub whose /query
answers a canned ~28 KB body (no batcher, no parse, no assembly), driven by
the bench's selector client (serve/loadclient.py). The gap between this and
torch_serve_host_profile.py's rate is the batcher + parse + assembly budget.

    python3 experiments/torch_http_echo_probe.py [--conns 256] [--device cuda]
        [--warmS 2] [--seconds 8]

Nothing here runs on a device; --device only names the card the host
belongs to in the result (and, as in every experiment of the port, cuda is
refused where CUDA is absent). Prints the original's lines, then one JSON
line; main() returns the same dict.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


class StubServer:
    """What the front end reads of a SearchServer, answering every query
    with `body`."""

    class engine:
        class index:
            n_docs = 1

    batcher = None

    def __init__(self, body: bytes) -> None:
        self._body = body

    def handle_query_json(self, query: str) -> bytes:
        return self._body


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--conns", type=int, default=256)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu, never a fallback")
    ap.add_argument("--warmS", type=float, default=2.0)
    ap.add_argument("--seconds", type=float, default=8.0)
    args = ap.parse_args(argv)

    from spaghettisearch_tpu_torch import bench
    from spaghettisearch_tpu_torch.serve.fastloop import FastHTTPFrontend
    from spaghettisearch_tpu_torch.serve.loadclient import LoadClient, post_query

    device = bench._check_device(args.device)
    body = b"[" + b",".join(b'{"x":"' + b"a" * 500 + b'"}' for _ in range(50)) + b"]"
    print(f"body: {len(body)} bytes")
    static = os.path.join(REPO, "spaghettisearch_tpu_torch", "serve", "static")
    front = FastHTTPFrontend(StubServer(body), static, {})
    _, port = front.start("127.0.0.1", 0)
    bench._raise_open_files(args.conns)
    client = LoadClient(port, [post_query("warm up test")], args.conns)
    try:
        client.pump(args.warmS)
        client.reset()
        dt = client.pump(args.seconds)
    finally:
        client.close()
        front.shutdown()
    res = {"http_echo_rps": client.done / dt, "body_bytes": len(body), "conns": args.conns,
           "requests": client.done, "non_200": client.non_200,
           "protocol_errors": client.protocol_errors, "window_s": dt,
           "host_cores": os.cpu_count(), **bench.card(device)}
    print(f"http echo: {res['http_echo_rps']:.0f} req/s at {len(body)}B bodies, "
          f"conns={args.conns}")
    return res


if __name__ == "__main__":
    print(json.dumps(main()), flush=True)
