"""The server of the ``serve_open`` traffic kind, in a process of its own.

    python3 portbench/lib/serve_child.py <config json> <device> <trace path>

Builds the configuration's codec and a ``serve.CodecServer`` at the
``serve`` command's defaults on 127.0.0.1, a free port, and answers one
command a line on its standard input with one ``PB <json>`` line on its
standard output: ``trace_start`` / ``trace_stop`` (a profiler trace of the
server's process; the summary goes to the trace path), ``peak`` (the
device's peak memory) and ``quit``.
"""

import contextlib
import json
import sys
from pathlib import Path


def reply(obj) -> None:
    print("PB " + json.dumps(obj), flush=True)


def main(argv) -> int:
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import torch

    from audiocodec_tpu_torch import serve
    from portbench.lib import harness, program, trace

    config, device, trace_path = json.loads(argv[0]), argv[1], argv[2]
    codec = program.codec(config, device)
    server = serve.CodecServer(codec, config["sample_rate"]).start()
    reply({"port": server.port, "device": harness.device_info(device)})
    stack, summary = contextlib.ExitStack(), None
    try:
        for line in sys.stdin:
            cmd = line.strip()
            if cmd == "trace_start":
                summary = stack.enter_context(trace.traced(device))
                reply({})
            elif cmd == "trace_stop":
                stack.close()
                with open(trace_path, "w") as f:
                    json.dump(summary, f)
                reply({})
            elif cmd == "peak":
                peak = (torch.cuda.max_memory_allocated(device)
                        if torch.device(device).type == "cuda" else 0)
                reply({"peak": int(peak)})
            elif cmd == "quit":
                break
    finally:
        stack.close()
        server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
