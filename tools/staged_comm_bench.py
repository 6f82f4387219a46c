"""Times the collectives of two processes sharing one card through gloo,
their CUDA operands staged through pinned host memory (parallel/comm.py's
``staged_device="cuda"`` mode, the transport of chip_smoke.phase_tp_train),
at the sizes a tp-2 rank of the 14B moves at 16384 tokens: a [1, 16384,
5120] bf16 activation (168 MB) and its half.

    python3 tools/staged_comm_bench.py

Prints each collective's median of 3 calls on both ranks: the staged
DistComm calls (the sums and concatenations on the card, the pieces point
to point), gloo's own all_reduce / all_gather and a point-to-point exchange
on host tensors, the pinned copy alone, and a bf16 sum on the host.
"""
import socket
import statistics
import time

import torch
import torch.multiprocessing as mp


def _worker(rank, port, out):
    import torch.distributed as dist

    from long_vita_tpu_torch.parallel.comm import init_process_group

    comm = init_process_group(rank, 2, f"tcp://127.0.0.1:{port}", backend="gloo",
                              staged_device="cuda")
    x = torch.randn(1, 16384, 5120, device="cuda").to(torch.bfloat16)
    half = x[:, :8192].contiguous()
    hx = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    hx.copy_(x)
    hh = torch.empty(half.shape, dtype=x.dtype, pin_memory=True)
    hh.copy_(half)
    res = {}

    def timed(name, fn, n=3):
        times = []
        for _ in range(n):
            comm.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        res[name] = statistics.median(times)

    def p2p():
        recv = torch.empty_like(hh)
        ops = [dist.P2POp(dist.isend, hh, 1 - rank), dist.P2POp(dist.irecv, recv, 1 - rank)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()

    timed("staged all_gather of 84 MB pieces", lambda: comm.all_gather(half, 1))
    timed("staged reduce_scatter of 168 MB", lambda: comm.reduce_scatter(x, 1))
    timed("staged all_reduce of 168 MB", lambda: comm.all_reduce_sum(x))
    timed("host gloo all_reduce, bf16 168 MB", lambda: dist.all_reduce(hx.clone()))
    timed("host gloo all_gather, bf16 84 MB pieces",
          lambda: dist.all_gather([torch.empty_like(hh), torch.empty_like(hh)], hh))
    timed("host point-to-point exchange of 84 MB", p2p)
    timed("device to pinned host copy of 168 MB", lambda: hx.copy_(x))
    timed("host bf16 sum of two 84 MB pieces", lambda: torch.stack([hh, hh]).sum(0))
    out.put((rank, res))
    dist.destroy_process_group()


def main() -> None:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_worker, args=(r, port, out)) for r in range(2)]
    for p in procs:
        p.start()
    try:
        res = dict(out.get(timeout=600) for _ in range(2))
    finally:
        for p in procs:
            p.join(60)
            if p.is_alive():
                p.kill()
    for name in res[0]:
        print(f"{name}: rank 0 {res[0][name]:.3f} s, rank 1 {res[1][name]:.3f} s")


if __name__ == "__main__":
    main()
