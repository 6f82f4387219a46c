"""PyTorch port: inference/cli.py against the JAX package's CLI, on a
synthetic checkpoint directory at tiny_test_config() in f32 on the CPU.

The same argv gives the same parsed values; build_engine, with
load_tokenizer replaced by one shared ByteTokenizer (no tokenizer files are
in the repository), serves the JAX build_engine's greedy tokens, and main's
prompt, beam and chat modes print the JAX CLI's text. Tolerance: none
(greedy token ids and printed text must be identical). The port's default
device is the card: without one, build_engine raises.
"""
import argparse
import builtins
import functools

import numpy as np
import pytest
import torch

import long_vita_tpu.inference.cli as jax_cli
import long_vita_tpu.tokenizer as jax_tokenizer
import long_vita_tpu.utils.compile_cache as jax_compile_cache
import long_vita_tpu_torch.inference.cli as port_cli
import long_vita_tpu_torch.tokenizer as port_tokenizer
from long_vita_tpu.inference.sampler import SamplingParams as JaxSP
from long_vita_tpu_torch.config import tiny_test_config
from long_vita_tpu_torch.inference.sampler import SamplingParams
from long_vita_tpu_torch.models.long_vita import init_long_vita_params
from long_vita_tpu_torch.utils.export_hf import save_hf_checkpoint
from test_torch_quantize import one_torch_thread  # noqa: F401
from test_torch_serving import tiny_tokenizer

ARGVS = [
    ["ckpt"],
    ["ckpt", "--prompt", "<image>\nDescribe.", "--image", "a.jpg", "--image", "b.jpg",
     "--video", "v.mp4", "--max-new-tokens", "7", "--temperature", "0.5", "--top-p", "0.9"],
    ["ckpt", "--serve", "--continuous", "--port", "5009", "--host", "127.0.0.1",
     "--kv-quant", "--weight-quant", "int4", "--prefix-cache", "2", "--speculative", "4"],
    ["ckpt", "--chat", "--beam-size", "3", "--max-seq-len", "4096", "--chunk", "512",
     "--max-num-frame", "32", "--dtype", "float32", "--tp", "2", "--cp", "4", "--top-k", "5"],
]


class _Parsed(Exception):
    pass


@pytest.mark.parametrize("argv", ARGVS, ids=["defaults", "prompt", "serve", "chat"])
def test_argparse_gives_the_jax_values(argv, monkeypatch):
    monkeypatch.setattr(jax_compile_cache, "enable", lambda *a, **k: None)
    seen = []
    parse = argparse.ArgumentParser.parse_args

    def capture(self, args=None, namespace=None):
        seen.append(vars(parse(self, args, namespace)))
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    for cli in (jax_cli, port_cli):
        with pytest.raises(_Parsed):
            cli.main(argv)
    assert seen[0] == seen[1]


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A tiny Long-VITA *_HF directory with random f32 weights (written by
    the port's exporter; config.json included)."""
    cfg = tiny_test_config()
    params = init_long_vita_params(torch.Generator().manual_seed(3), cfg)
    with torch.no_grad():  # wider weights: greedy decoding that is not a loop
        for name, p in params.text.named_parameters():
            if p.ndim == 2 and "embed" not in name:
                p.mul_(8)
    path = tmp_path_factory.mktemp("ckpt")
    save_hf_checkpoint(params, cfg, str(path))
    return str(path)


@pytest.fixture()
def stub_tokenizer(monkeypatch):
    """load_tokenizer of both packages returns one shared ByteTokenizer."""
    tok = tiny_tokenizer()
    for module in (jax_tokenizer, port_tokenizer):
        monkeypatch.setattr(module, "load_tokenizer", lambda path, template="long_vita": tok)
    monkeypatch.setattr(jax_compile_cache, "enable", lambda *a, **k: None)
    return tok


def test_build_engine_serves_the_jax_tokens(checkpoint, stub_tokenizer):
    kw = dict(max_seq_len=512, chunk=64, dtype_name="float32")
    port = port_cli.build_engine(checkpoint, device="cpu", **kw)
    ref = jax_cli.build_engine(checkpoint, **kw)
    assert port.text.embed.dtype == torch.float32 and port.device.type == "cpu"
    assert port.mm.tokenizer is stub_tokenizer is ref.mm.tokenizer
    msgs = [{"role": "user", "content": "what does the checkpoint say?"}]
    got = port.generate(msgs, sampling=SamplingParams(max_new_tokens=10, return_logprobs=True))
    want = ref.generate(msgs, sampling=JaxSP(max_new_tokens=10, return_logprobs=True))
    assert got.token_ids == want.token_ids and got.text == want.text
    assert len(set(got.token_ids)) > 3, got.token_ids
    np.testing.assert_allclose(got.logprobs, want.logprobs, rtol=0, atol=1e-4)


def _main_output(cli, argv, capsys, monkeypatch, inputs=()):
    if cli is port_cli:
        monkeypatch.setattr(cli, "build_engine",
                            functools.partial(port_cli.build_engine, device="cpu"))
    lines = iter(inputs)
    monkeypatch.setattr(builtins, "input", lambda prompt="": next(lines))
    capsys.readouterr()
    cli.main(argv)
    return capsys.readouterr().out


@pytest.mark.parametrize("extra,inputs", [
    (["--prompt", "say something"], ()),
    (["--prompt", "beam it", "--beam-size", "2"], ()),
    (["--chat"], ("hello", "clear", "hi again", "and more", "exit")),
], ids=["prompt", "beam", "chat"])
def test_main_prints_the_jax_text(checkpoint, stub_tokenizer, capsys, monkeypatch, extra, inputs):
    argv = [checkpoint, "--dtype", "float32", "--max-seq-len", "512", "--chunk", "64",
            "--max-new-tokens", "8", *extra]
    got = _main_output(port_cli, argv, capsys, monkeypatch, inputs)
    want = _main_output(jax_cli, argv, capsys, monkeypatch, inputs)
    assert got == want and got.strip()


def test_serve_starts_the_port_server(checkpoint, stub_tokenizer, monkeypatch):
    calls = []
    import long_vita_tpu_torch.inference.server as port_server

    monkeypatch.setattr(port_server, "run_server", lambda *a, **k: calls.append((a, k)))
    monkeypatch.setattr(port_cli, "build_engine",
                        functools.partial(port_cli.build_engine, device="cpu"))
    port_cli.main([checkpoint, "--dtype", "float32", "--serve", "--continuous",
                   "--host", "127.0.0.1", "--port", "5123", "--max-seq-len", "512",
                   "--chunk", "64"])
    (args, kw), = calls
    assert args[1:] == ("127.0.0.1", 5123) and kw == {"continuous": True}
    assert args[0].max_seq_len == 512 and args[0].chunk == 64


@pytest.mark.parametrize("kw", [dict(tp=2), dict(cp=2)])
def test_mesh_flags_raise_until_multi_gpu(checkpoint, stub_tokenizer, kw, monkeypatch):
    """tp and cp serve from a job of tp x cp processes, so one process
    asking for tp 2 or cp 2 is told to use torchrun."""
    for var in ("RANK", "WORLD_SIZE", "LVT_COORDINATOR"):
        monkeypatch.delenv(var, raising=False)
    flag = "--tp 2" if "tp" in kw else "--cp 2"
    with pytest.raises(ValueError, match=f"torchrun --nproc-per-node 2 .* {flag}"):
        port_cli.build_engine(checkpoint, device="cpu", **kw)


def test_chat_over_cp_raises(checkpoint):
    for flag in ("--cp", "--tp"):
        with pytest.raises(SystemExit):
            port_cli.main([checkpoint, "--chat", flag, "2"])


CP_PAYLOADS = [
    {"prompts": ["served from two ranks"], "tokens_to_generate": 8},
    {"prompts": ["with logprobs"], "tokens_to_generate": 6, "logprobs": True},
    {"prompts": ["two rows", "in one request"], "tokens_to_generate": 5},
]


def _cli_serve_worker(rank, world, init, ckpt, http_port, flag, out):
    """One gloo process of `cli.main([ckpt, "--serve", "--continuous",
    flag, "2", ...])` (flag "--cp" or "--tp"), started as torchrun's would be but through the
    LVT_* variables: the stub tokenizer, the CPU, rank 0's client on a
    thread of its own process (it PUTs CP_PAYLOADS, then shuts the server
    down)."""
    import os
    import threading
    import time as time_mod

    torch.set_num_threads(1)
    try:
        from test_torch_serving import _put

        import long_vita_tpu_torch.inference.server as port_server

        os.environ.update(LVT_COORDINATOR=init.removeprefix("tcp://"),
                          LVT_NUM_PROCESSES=str(world), LVT_PROCESS_ID=str(rank))
        tok = tiny_tokenizer()
        port_tokenizer.load_tokenizer = lambda path, template="long_vita": tok
        port_cli.build_engine = functools.partial(port_cli.build_engine, device="cpu")
        got = {}
        if rank == 0:
            servers, make = [], port_server.make_server

            def recording_make(*a, **k):
                servers.append(make(*a, **k))
                return servers[-1]

            port_server.make_server = recording_make

            def client():
                deadline = time_mod.monotonic() + 120
                while not servers and time_mod.monotonic() < deadline:
                    time_mod.sleep(0.05)
                try:
                    url = f"http://127.0.0.1:{http_port}/api"
                    got["answers"] = [_put(url, p) for p in CP_PAYLOADS]
                finally:
                    servers[0].shutdown()

            threading.Thread(target=client, daemon=True).start()
        port_cli.main([ckpt, "--dtype", "float32", "--max-seq-len", "512", "--chunk", "64",
                       "--serve", "--continuous", flag, str(world), "--host", "127.0.0.1",
                       "--port", str(http_port)])
        out.put((rank, got.get("answers", "followed until shutdown")))
    except Exception as e:  # noqa: BLE001 (reported to the parent)
        import traceback

        out.put((rank, f"raised {type(e).__name__}: {e}\n{traceback.format_exc()[-1500:]}"))


def test_cli_serves_cp_2_from_two_gloo_processes(checkpoint, stub_tokenizer, one_torch_thread):
    """torchrun's launch, rehearsed: two gloo processes run cli.main with
    --serve --continuous --cp 2; rank 0 answers HTTP, rank 1 replays it and
    exits after rank 0's shutdown, both with code 0; the answers equal the
    one-process port server's on the same checkpoint (text identical,
    logprobs within 1e-4)."""
    _cli_against_one_process(checkpoint, "--cp")


def test_cli_serves_tp_2_from_two_gloo_processes(checkpoint, stub_tokenizer, one_torch_thread):
    """The same launch with --tp 2: each process keeps its shard of the
    weights and of the cache's kv heads; rank 0 answers HTTP, rank 1
    replays it; the answers equal the one-process port server's."""
    _cli_against_one_process(checkpoint, "--tp")


def _cli_against_one_process(checkpoint, flag):
    import json

    import long_vita_tpu_torch.inference.server as port_server
    from test_torch_comm import free_port, run_gloo
    from test_torch_serving import _put, _serve, _stop

    codes = {}
    got = run_gloo(_cli_serve_worker, 2, checkpoint, free_port(), flag, join_timeout=240,
                   exitcodes=codes)
    assert isinstance(got.get(0), list) and got.get(1) == "followed until shutdown", got
    assert codes == {0: 0, 1: 0}, codes
    engine = port_cli.build_engine(checkpoint, device="cpu", max_seq_len=512, chunk=64,
                                   dtype_name="float32")
    server, thread, url = _serve(port_server, engine, continuous=True, max_batch=8, tick=16)
    try:
        want = [_put(url, p) for p in CP_PAYLOADS]
    finally:
        _stop(server, thread)
    for (code, body), (wcode, wbody) in zip(got[0], want):
        assert code == wcode == 200, body
        g, w = json.loads(body), json.loads(wbody)
        if "logprobs" in w:
            np.testing.assert_allclose(g.pop("logprobs")[0], w.pop("logprobs")[0], rtol=0,
                                       atol=1e-4)
        assert g == w and all(g["text"])


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA device is present")
def test_default_device_is_the_card(checkpoint, stub_tokenizer):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cli.build_engine(checkpoint)
