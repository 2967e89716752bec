"""What torch.distributed does on a machine with one CUDA card.

    python -m samplenerfro_torch.debug.dist_probe

Three checks, each printed on a line of its own:
  1. an NCCL group of world 1 in this process: an all_reduce captured in
     a CUDA graph on a side stream (the communicator made by an eager
     call first) and replayed, bit for bit the eager result;
  2. two processes asking NCCL for ranks on the one card (cuda:0): the
     error NCCL gives (two ranks need two devices);
  3. two processes over gloo with CUDA tensors on the one card: which of
     all_reduce, broadcast and all_gather gloo takes.
Exits non-zero when no card is present or a check gives no answer.
"""

import os
import socket
import subprocess
import sys
import traceback

import torch
import torch.distributed as dist

TIMEOUT_S = 120


def free_port():
  with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    return s.getsockname()[1]


def _step(x):
  x.mul_(1.5).add_(0.25)
  dist.all_reduce(x)
  return x


def nccl_world_one():
  """An all_reduce on a side stream, eager and replayed from a graph."""
  dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                          rank=0, world_size=1)
  try:
    dev = torch.device("cuda", 0)
    seed = torch.randn(4096, device=dev, generator=torch.Generator(
        device=dev).manual_seed(0))
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):
      eager = _step(seed.clone())
      eager = _step(eager)
      static = seed.clone()
      graph = torch.cuda.CUDAGraph()
      with torch.cuda.graph(graph, stream=stream):
        _step(static)
    torch.cuda.current_stream(dev).wait_stream(stream)
    static.copy_(seed)
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    nccl = ".".join(map(str, torch.cuda.nccl.version()))
    print(f"nccl world 1: NCCL {nccl}; captured all_reduce replayed twice "
          f"bit for bit eager: {torch.equal(static, eager)}", flush=True)
    return torch.equal(static, eager)
  finally:
    dist.destroy_process_group()


def worker(backend, rank, port):
  """One of two ranks on cuda:0; prints what each collective did."""
  dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                          rank=rank, world_size=2)
  dev = torch.device("cuda", 0)
  torch.cuda.set_device(dev)
  x = torch.full((8,), float(rank + 1), device=dev)
  for name, fn in (
      ("all_reduce", lambda: dist.all_reduce(x)),
      ("broadcast", lambda: dist.broadcast(x, 0)),
      ("all_gather", lambda: dist.all_gather(
          [torch.empty_like(x) for _ in range(2)], x))):
    try:
      fn()
      torch.cuda.synchronize()
      print(f"{backend} rank {rank} {name}: ok {x[:2].tolist()}", flush=True)
    except Exception as e:  # the answer this probe looks for
      msg = str(e).splitlines()[0][:300] if str(e) else type(e).__name__
      print(f"{backend} rank {rank} {name}: {type(e).__name__}: {msg}",
            flush=True)
      if backend == "nccl":
        break
  dist.destroy_process_group()


def pair(backend):
  port = free_port()
  procs = [subprocess.Popen(
      [sys.executable, "-m", "samplenerfro_torch.debug.dist_probe",
       "--worker", backend, str(r), str(port)],
      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
           for r in range(2)]
  try:
    outs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
  except subprocess.TimeoutExpired:
    for p in procs:
      p.kill()
      p.wait()
    print(f"{backend} pair: no answer in {TIMEOUT_S} s", flush=True)
    return False
  for r, (p, out) in enumerate(zip(procs, outs)):
    lines = [l for l in out.splitlines() if l.startswith(backend)]
    tail = lines or out.strip().splitlines()[-3:]
    print(f"{backend} pair, rank {r} exit {p.returncode}:\n  "
          + "\n  ".join(tail), flush=True)
  return True


def main():
  if len(sys.argv) == 5 and sys.argv[1] == "--worker":
    worker(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
    return 0
  if not torch.cuda.is_available():
    print("dist_probe: no CUDA card", file=sys.stderr)
    return 1
  print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}",
        flush=True)
  ok = True
  try:
    ok = nccl_world_one()
  except Exception:  # reported, and the probe fails
    traceback.print_exc()
    ok = False
  ok = pair("nccl") and ok
  ok = pair("gloo") and ok
  return 0 if ok else 1


if __name__ == "__main__":
  os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "1")
  sys.exit(main())
