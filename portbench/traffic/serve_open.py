"""Traffic kind ``serve_open``: requests of many clients through ``serve``.

An open loop of Poisson arrivals of ``'E'`` requests at ``rate`` a second,
each a PCM16 WAV from a pool of ``pool`` clips whose lengths are
log-normal (median ``median_s``, shape ``sigma``, clipped to
``min_s``..``max_s``). Requests go over ``connections`` persistent TCP
connections to a ``serve.CodecServer`` at the serve command's defaults in a
child process (``lib/serve_child.py``); the generator runs in this process.
A request is timed from when it was due until its whole response was read;
when every connection is busy at its due time it goes late, and that wait
counts. The set of clip lengths and of gaps between arrivals is the same for
every seed (drawn from ``base_seed``); the seed orders them and makes the
audio. ``check`` responses drawn from the seed, and the longest clip's
first, are compared with the reference.
"""

from __future__ import annotations

import json
import math
import os
import random
import socket
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from portbench.lib import audio, harness
from portbench.reference import containers
from portbench.reference.codec import Err, Reference

HDR = struct.Struct(">BI")
TIMEOUT_S = 60.0


class ChildServer:
    """The server in its own process; ``command`` sends one line."""

    def __init__(self, run):
        self.trace_path = os.path.join(run.scratch, "server-trace.json")
        child = os.path.join(os.path.dirname(harness.__file__),
                             "serve_child.py")
        self.proc = subprocess.Popen(
            [sys.executable, child, json.dumps(run.config), str(run.device),
             self.trace_path],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        hello = self._read()
        self.port = hello["port"]
        self.device = tuple(hello["device"])

    def _read(self) -> dict:
        for line in self.proc.stdout:
            if line.startswith("PB "):
                return json.loads(line[3:])
        raise harness.Failure(
            f"the server exited (code {self.proc.wait()})")

    def command(self, cmd: str) -> dict:
        self.proc.stdin.write(cmd + "\n")
        self.proc.stdin.flush()
        return self._read()

    def trace_start(self):
        self.command("trace_start")

    def trace_stop(self) -> dict:
        self.command("trace_stop")
        with open(self.trace_path) as f:
            return json.load(f)

    def peak(self) -> int:
        return self.command("peak")["peak"]

    def stop(self) -> None:
        if self.proc.poll() is None:
            try:
                self.proc.stdin.write("quit\n")
                self.proc.stdin.close()
            except OSError:
                pass
        try:
            self.proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()


def call(sock, op: bytes, payload: bytes):
    """One request on a connection -> (status, response bytes)."""
    sock.sendall(HDR.pack(op[0], len(payload)) + payload)

    def exact(n):
        buf = bytearray()
        while len(buf) < n:
            part = sock.recv(n - len(buf))
            if not part:
                raise ConnectionError("server closed the connection")
            buf.extend(part)
        return bytes(buf)

    status, length = HDR.unpack(exact(HDR.size))
    return status, exact(length)


def plan(run):
    """-> (clip lengths in samples, [(due s, clip id)])."""
    p, sr = run.params, run.config["sample_rate"]
    fixed = random.Random(p["base_seed"])
    lengths = [int(round(sr * min(max(
        p["median_s"] * math.exp(fixed.gauss(0.0, p["sigma"])), p["min_s"]),
        p["max_s"]))) for _ in range(p["pool"])]
    total = int(round(p["rate"] * run.seconds))
    gaps = [fixed.expovariate(p["rate"]) for _ in range(total)]
    order = random.Random(harness.sub_seed(run.seed, "order"))
    order.shuffle(gaps)
    ids = [i % p["pool"] for i in range(total)]
    order.shuffle(ids)
    return lengths, list(zip(np.cumsum(gaps).tolist(), ids))


def clips(run, lengths):
    """The pool's audio as int16 numpy [S, C] (host)."""
    cfg = run.config
    return [audio.pcm16(audio.music(
        harness.sub_seed(run.seed, "clip", i), 1, s, cfg["channels"],
        cfg["sample_rate"], "cpu"))[0].numpy() for i, s in enumerate(lengths)]


def connect(port: int, count: int):
    socks = []
    for _ in range(count):
        s = socket.create_connection(("127.0.0.1", port), timeout=TIMEOUT_S)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        socks.append(s)
    return socks


def stats(sock) -> dict:
    status, body = call(sock, b"Q", b"")
    if status != 0:
        raise harness.Failure(f"'Q' failed: {body!r}")
    return json.loads(body)


def drive(socks, payloads, schedule, keep_ids):
    """The window: every request of ``schedule`` at its due time (relative
    to the start), each on the first free connection. -> (start, latencies
    (inf where failed), lateness, responses of ``keep_ids``)."""
    n = len(schedule)
    lat = [math.inf] * n
    late = [0.0] * n
    kept = {}
    lock = threading.Lock()
    nxt = [0]
    start = time.perf_counter() + 0.05

    def worker(sock):
        while True:
            with lock:
                i = nxt[0]
                nxt[0] += 1
            if i >= n:
                return
            due = start + schedule[i][0]
            wait = due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            late[i] = max(0.0, time.perf_counter() - due)
            try:
                status, body = call(sock, b"E", payloads[schedule[i][1]])
            except OSError:
                continue  # no response: counted as failed
            if status == 0:
                lat[i] = time.perf_counter() - due
                if i in keep_ids:
                    kept[i] = body

    threads = [threading.Thread(target=worker, args=(s,)) for s in socks]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return start, lat, late, kept


def p95(latencies) -> float:
    """Nearest-rank 95th percentile; failed requests (inf) rank last."""
    ordered = sorted(latencies)
    return ordered[max(0, math.ceil(0.95 * len(ordered)) - 1)]


def run(run, server_factory=ChildServer):
    cfg, p = run.config, run.params
    lengths, schedule = plan(run)
    pcm = clips(run, lengths)
    payloads = [audio.wav_bytes(c, cfg["sample_rate"]) for c in pcm]
    check_ids = chosen(run, schedule, lengths)
    server = server_factory(run)
    try:
        socks = connect(server.port, p["connections"])
        warm = random.Random(harness.sub_seed(run.seed, "warm"))
        for _ in range(p["warm_rounds"]):  # bursts: groups of every size
            picks = [warm.randrange(len(payloads)) for _ in socks]
            threads = [threading.Thread(target=call, args=(
                s, b"E", payloads[k])) for s, k in zip(socks, picks)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        before = stats(socks[0])
        if run.trace:
            server.trace_start()
        start, lat, late, kept = drive(socks, payloads, schedule, check_ids)
        end = start + max((due + x for (due, _), x in zip(schedule, lat)
                           if math.isfinite(x)), default=0.0)
        summary = server.trace_stop() if run.trace else None
        after = stats(socks[0])
        memory = server.peak()
        for s in socks:
            s.close()
    finally:
        server.stop()
    failed = sum(1 for x in lat if not math.isfinite(x))
    q = p95(lat)
    lateness = sorted(late)
    run.log(f"{len(schedule)} requests at {p['rate']}/s over "
            f"{end - start:.3f} s; generator late p50 "
            f"{1e3 * lateness[len(lateness) // 2]:.3f} ms, p95 "
            f"{1e3 * p95(late):.3f} ms, max {1e3 * lateness[-1]:.3f} ms; "
            f"completed {(len(lat) - failed) / max(end - start, 1e-9):.1f}/s")
    fifths = [1e3 * p95(lat[k * len(lat) // 5:(k + 1) * len(lat) // 5])
              for k in range(5)]
    run.log("p95 ms by fifth of the window: "
            + " ".join(f"{v:.1f}" for v in fifths)
            + "; stage s " + " ".join(
                f"{k[2:-2]} {after.get(k, 0.0) - before.get(k, 0.0):.3f}"
                for k in sorted(after) if k.startswith("t_")))
    bad, err = check(run, schedule, lengths, pcm, kept, check_ids)
    return harness.Outcome(
        attempted=len(schedule), failed=failed,
        end_to_end={"p95_ms": 1e3 * q if math.isfinite(q) else 1e12},
        checks=[("bad", bad), ("err", err)], summary=summary,
        ops=len(schedule), counters={"before": before, "after": after},
        memory_peak=memory, device=server.device,
        setup_s=start - run.t0)


def pad_blocks(samples, n: int) -> torch.Tensor:
    """int16 [S, C] -> float64 [1, S', C], S' whole blocks, zeros after:
    what the server encodes."""
    x = torch.from_numpy(samples).to(torch.float64) / 32768.0
    pad = -x.shape[0] % n
    return torch.nn.functional.pad(x.T, (0, pad)).T[None]


def chosen(run, schedule, lengths) -> set:
    rng = random.Random(harness.sub_seed(run.seed, "check"))
    picks = set(rng.sample(range(len(schedule)),
                           min(run.params["check"], len(schedule))))
    longest = max(range(len(lengths)), key=lengths.__getitem__)
    firsts = [i for i, (_, k) in enumerate(schedule) if k == longest]
    return picks | set(firsts[:1])


def check(run, schedule, lengths, pcm, kept, check_ids):
    """(checked responses that do not parse or frame as the request says,
    their error energy of dequantized frames over the reference's)."""
    cfg = run.config
    ref = Reference(cfg, run.device)
    bad, err = 0, Err()
    for i in sorted(check_ids):
        if i not in kept:
            continue  # failed: counted apart
        k = schedule[i][1]
        try:
            got = containers.read_acz(kept[i], cfg)
            blocks = -(-lengths[k] // cfg["filters_n"])
            if got["nsamp"] != lengths[k] or got["codes"].shape[1] != \
                    blocks + 1:
                raise ValueError(f"nsamp {got['nsamp']} or frames "
                                 f"{got['codes'].shape}")
            x = pad_blocks(pcm[k], cfg["filters_n"])
            _, _, expect = ref.encode(ref.frames(x, 0, blocks + 1))
            err.add(ref.dequantize(got["codes"], got["levels"]), expect)
        except ValueError as e:
            run.log(f"response {i}: {e}")
            bad += 1
    return bad, err.value


def control(run, ref) -> float:
    """The check's error with ``ref`` (the reference at a lower precision)
    in the program's place, on the requests a run would check."""
    cfg = run.config
    lengths, schedule = plan(run)
    pcm = clips(run, lengths)
    exact = Reference(cfg, run.device)
    err = Err()
    for i in sorted(chosen(run, schedule, lengths)):
        k = schedule[i][1]
        blocks = -(-lengths[k] // cfg["filters_n"])
        x = pad_blocks(pcm[k], cfg["filters_n"])
        codes, levels, _ = ref.encode(ref.frames(x, 0, blocks + 1))
        _, _, expect = exact.encode(exact.frames(x, 0, blocks + 1))
        err.add(exact.dequantize(codes.cpu(), levels.cpu()), expect)
    return err.value
