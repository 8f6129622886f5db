"""The port's one CUDA-graph mechanism (khmer_ocr_torch/cuda_graphs.py) and
its launch registry (khmer_ocr_torch/ops/kernels/build.py::launches).

* ``GraphCache``: the least recently used entries evicted until a new one
  fits the budget, an entry larger than the budget kept alone, ``make``
  run only for a key not cached; other params (the weights, or a tuple of
  the objects the graphs read and write) drop every entry, and what the
  entries share is made once for the params.
* ``Graph``'s count bookkeeping: the launches on the capture's stream
  count to the capture and not to the registry, whichever thread makes
  them (the autograd engine runs a backward on a thread of its own); each
  replay adds them; launches on another stream during the capture stay in
  the registry. Only the capture itself needs the card: here
  ``torch.cuda.CUDAGraph`` and ``torch.cuda.graph`` are stand-ins.
* Each graph key (the decode's beam and greedy shapes, the encode, the train
  step, the layout train step and forward) changes with each of torch's
  switches that ``cuda_graphs.switches`` reads, and is the same again once
  the switch is back.
* Each kernel wrapper counts its launches into the registry and nowhere
  else (its source read with ``ast``, in the pytest process).

The torch side runs in one torch-only subprocess (this file run as a
script).
"""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
KERNELS = REPO / "khmer_ocr_torch" / "ops" / "kernels"

# id -> (budget, [(key, bytes), ...] asked in order, the keys cached after each ask (least recently used first),
# the keys made)
CACHE_CASES = {
    "evicts": (100, [("a", 40), ("b", 40), ("c", 40)], [["a"], ["a", "b"], ["b", "c"]], ["a", "b", "c"]),
    "recent-kept": (100, [("a", 40), ("b", 40), ("a", 40), ("c", 40)], [["a"], ["a", "b"], ["b", "a"], ["a", "c"]],
                    ["a", "b", "c"]),
    "evicted-made-again": (100, [("a", 40), ("b", 40), ("c", 40), ("a", 40)],
                           [["a"], ["a", "b"], ["b", "c"], ["c", "a"]], ["a", "b", "c", "a"]),
    "fits": (100, [("a", 30), ("b", 30), ("c", 30)], [["a"], ["a", "b"], ["a", "b", "c"]], ["a", "b", "c"]),
    "over-budget": (10, [("a", 40), ("b", 5)], [["a"], ["b"]], ["a", "b"]),
    "sizes-vary": (100, [("a", 60), ("b", 30), ("c", 50), ("d", 40), ("e", 100)],
                   [["a"], ["a", "b"], ["b", "c"], ["c", "d"], ["e"]], ["a", "b", "c", "d", "e"]),
    "exactly-full": (100, [("a", 50), ("b", 50), ("a", 50), ("c", 1)], [["a"], ["a", "b"], ["b", "a"], ["a", "c"]],
                     ["a", "b", "c"]),
    "largest-alone": (100, [("a", 10), ("b", 10), ("c", 150), ("d", 10)], [["a"], ["a", "b"], ["c"], ["d"]],
                      ["a", "b", "c", "d"]),
}
BIND_CASES = {"shared": {"same": True, "kept": 1, "dropped": 0, "made_again": True},
              "tuple": {"same": 1, "other_moments": 0, "other_model": 0}}
ROLES = ["decode_beam", "decode_greedy", "encode", "train", "layout_train", "detection"]
SWITCHES = ["matmul_tf32", "matmul_bf16_reduction", "float32_matmul_precision", "cudnn_tf32"]
# each kernel wrapper module -> the registry's counters it counts into
WRAPPERS = {"lstm": {"k1"}, "lstm_backward": {"k1b"}, "beam_step": {"k5"}, "decode_loop": {"k3"}, "smem_probe": {"k4"},
            "decode_step": {"k2", "k2_bf16", "k2_head", "k2_card", "k2_block"}}


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_cuda_graphs")
    subprocess.run([sys.executable, __file__, str(tmp)], cwd=REPO, check=True, timeout=300)
    return json.loads((tmp / "out.json").read_text())


@pytest.mark.parametrize("case", CACHE_CASES)
def test_cache_keeps_the_recent_entries_within_its_budget(port, case):
    """The cache evicts its least recently used entries until the new one
    fits its budget; an entry larger than the budget is kept, alone;
    ``make`` runs only for a key not cached."""
    budget, asked, kept, made = CACHE_CASES[case]
    got = port["cache"][case]
    assert got["kept"] == kept
    assert got["made"] == made
    assert got["nbytes"] == sum(dict(asked)[k] for k in kept[-1])


@pytest.mark.parametrize("case", BIND_CASES)
def test_cache_drops_every_entry_for_other_params(port, case):
    """``shared``: made once for the entries to share, the entries kept for
    the same params and dropped, with it, for others. ``tuple``: the
    objects the graphs read and write, compared item by item (a train
    state's model and moments)."""
    assert port["bind"][case] == BIND_CASES[case]


def test_capture_moves_its_launches_to_each_replay(port):
    """A stand-in body bumps two counters on the capture's stream, and a
    thread of its one more: the capture leaves the registry as it was and
    holds them; each replay adds them; a launch that another thread counts
    on another stream during the capture stays in the registry."""
    got = port["capture"]
    assert got["graph_launches"] == {"k2": 3, "k5": 1, "k1b": 1}
    assert got["after_capture"] == {"k1": 2}
    assert got["after_replays"] == {"k1": 2, "k2": 6, "k5": 2, "k1b": 2}
    assert got["body_out"] == "out" and got["capture_kwargs"] == {"pool": None, "stream": "side",
                                                                   "capture_error_mode": "thread_local"}
    assert got["lock_held_in_capture"]


@pytest.mark.parametrize("switch", SWITCHES)
@pytest.mark.parametrize("role", ROLES)
def test_key_changes_with_each_switch(port, role, switch):
    """A captured graph replays the kernels torch's switches picked: each
    role's key differs with the switch flipped, and is the same again
    once it is back."""
    assert port["keys"][role][switch] == {"differs": True, "restored": True}


@pytest.mark.parametrize("module", WRAPPERS)
def test_wrapper_counts_into_the_registry_alone(module):
    """The wrapper names the registry's counters in ``build.count_launch``
    calls and keeps no counter of its own: no ``global`` statement, no
    module-level name of launches, no reset or add function."""
    tree = ast.parse((KERNELS / f"{module}.py").read_text())
    counted = {kw.arg for node in ast.walk(tree) if isinstance(node, ast.Call)
               and isinstance(node.func, ast.Attribute) and node.func.attr == "count_launch"
               and isinstance(node.func.value, ast.Name) and node.func.value.id == "build" for kw in node.keywords}
    assert counted == WRAPPERS[module]
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Global)]
    top = {t.id for n in tree.body if isinstance(n, (ast.Assign, ast.AnnAssign))
           for t in (n.targets if isinstance(n, ast.Assign) else [n.target]) if isinstance(t, ast.Name)}
    assert not [n for n in top if "launches" in n]
    assert not [n.name for n in tree.body if isinstance(n, ast.FunctionDef) and "launches" in n.name]


# ---------------------------------------------------------------------------
# the port's side (torch only)
# ---------------------------------------------------------------------------


def _cache_cases(GraphCache) -> dict:
    from types import SimpleNamespace

    out = {}
    for case, (budget, asked, _, _) in CACHE_CASES.items():
        cache, made, kept = GraphCache(budget), [], []
        for key, nbytes in asked:
            entry = cache.get(key, lambda key=key, nbytes=nbytes: made.append(key) or SimpleNamespace(nbytes=nbytes))
            assert entry is cache.shapes[key]
            kept.append(list(cache.shapes))
        out[case] = {"kept": kept, "made": made, "nbytes": cache.nbytes}
    return out


def _bind_cases(torch, GraphCache) -> dict:
    from types import SimpleNamespace

    entry = lambda: SimpleNamespace(nbytes=1)  # noqa: E731
    made: list = []
    pack = lambda p: made.append(p) or {"packed": p}  # noqa: E731
    first, other = {"w": torch.zeros(1)}, {"w": torch.zeros(1)}
    cache = GraphCache(10**9)
    shared = cache.shared(first, pack)
    cache.get("x", entry)
    kept = len(cache)
    same = cache.shared(first, pack) is shared and len(made) == 1
    made_again = cache.shared(other, pack) is not shared and made == [first, other]
    out = {"shared": {"same": same, "kept": kept, "dropped": len(cache), "made_again": made_again}}

    cache, p0, mu = GraphCache(100), torch.zeros(1), [torch.zeros(1)]
    cache.bind((p0, mu))
    cache.get("k", entry)
    cache.bind((p0, mu))
    bind = {"same": len(cache)}
    cache.bind((p0, [torch.zeros(1)]))
    bind["other_moments"] = len(cache)
    cache.get("k", entry)
    cache.bind((torch.zeros(1), mu))
    bind["other_model"] = len(cache)
    out["tuple"] = bind
    return out


def _capture_case(torch, cuda_graphs, build) -> dict:
    import contextlib
    import threading
    from types import SimpleNamespace

    seen: dict = {}

    class FakeGraph:
        def replay(self):
            pass

    @contextlib.contextmanager
    def fake_capture(graph, **kwargs):
        seen["kwargs"] = {k: ("side" if v is side else v) for k, v in kwargs.items()}
        yield

    side = SimpleNamespace(cuda_stream=7)

    def on_thread(fn):
        t = threading.Thread(target=fn)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()

    def body():
        build.count_launch(7, k2=3)
        on_thread(lambda: build.count_launch(7, k1b=1))  # as a backward on the autograd engine's thread
        on_thread(lambda: build.count_launch(8, k1=2))  # another stream's launch: not this capture's
        seen["lock"] = cuda_graphs.capture_lock._is_owned()
        build.count_launch(7, k5=1)
        return "out"

    saved = torch.cuda.CUDAGraph, torch.cuda.graph
    torch.cuda.CUDAGraph, torch.cuda.graph = FakeGraph, fake_capture
    try:
        build.reset_launches()
        graph = cuda_graphs.Graph(body, side)
        after_capture = {k: n for k, n in build.launches.items() if n}
        graph.replay()
        graph.replay()
    finally:
        torch.cuda.CUDAGraph, torch.cuda.graph = saved
    return {"graph_launches": dict(graph.launches), "after_capture": after_capture,
            "after_replays": {k: n for k, n in build.launches.items() if n}, "body_out": graph.out,
            "capture_kwargs": seen["kwargs"], "lock_held_in_capture": seen["lock"]}


def _key_cases(torch) -> dict:
    import contextlib
    from types import SimpleNamespace

    from khmer_ocr_torch.config import DecodeConfig, ModelConfig
    from khmer_ocr_torch.convert.from_jax import params_from_jax, seeded_params
    from khmer_ocr_torch.decode import graphs
    from khmer_ocr_torch.decode.beam import beam_decode
    from khmer_ocr_torch.decode.greedy import greedy_decode
    from khmer_ocr_torch.detection.graphs import forward_key, train_key
    from khmer_ocr_torch.infer.encode_graph import encode_key
    from khmer_ocr_torch.train.graphs import graph_key

    cfg = ModelConfig(emb_dim=32, num_heads=2, enc_layers=1, dec_layers=1, enc_ffn_dim=64, max_global_len=64,
                      decode_max_len=16, backbone="vgg", use_bilstm=False, vocab_size=24)
    params = params_from_jax(*seeded_params(cfg, 0), cfg)
    memory, pad = torch.zeros(2, 8, 32), torch.zeros(2, 8, dtype=torch.bool)

    class Key(Exception):
        pass

    def stop(cache, key, *args):
        raise Key(key)

    def decode_key(fn, beam_width):
        saved, graphs.decode = graphs.decode, stop
        try:
            fn(params, memory, pad, cfg, DecodeConfig(beam_width=beam_width, max_len=8, eos_idx=3))
        except Key as k:
            return k.args[0]
        finally:
            graphs.decode = saved
        raise AssertionError("the decode made no key")

    images, labels = torch.zeros(2, 3, 32, 32), torch.zeros(2, 32, 32, dtype=torch.long)
    keys = {"decode_beam": lambda: decode_key(beam_decode, 3),
            "decode_greedy": lambda: decode_key(greedy_decode, 1),
            "encode": lambda: encode_key(params, torch.zeros(2, 48, 184, dtype=torch.uint8)),
            "train": lambda: graph_key(("step",), {"lines": torch.zeros(1, 2, 48, 184)}, 1),
            "layout_train": lambda: train_key(SimpleNamespace(training=True), images, labels),
            "detection": lambda: forward_key(SimpleNamespace(training=False), images, (32, 32), True)}
    m, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn

    def setter(name):
        return {"matmul_tf32": lambda v: setattr(m, "allow_tf32", v),
                "matmul_bf16_reduction": lambda v: setattr(m, "allow_bf16_reduced_precision_reduction", v),
                "float32_matmul_precision": torch.set_float32_matmul_precision,
                "cudnn_tf32": lambda v: setattr(cudnn, "allow_tf32", v)}[name]

    flipped = {"matmul_tf32": not m.allow_tf32, "matmul_bf16_reduction": not m.allow_bf16_reduced_precision_reduction,
               "float32_matmul_precision": "medium" if torch.get_float32_matmul_precision() != "medium" else "highest",
               "cudnn_tf32": not cudnn.allow_tf32}

    @contextlib.contextmanager
    def switched(name):
        saved = (m.allow_tf32, m.allow_bf16_reduced_precision_reduction, cudnn.allow_tf32,
                 torch.get_float32_matmul_precision())
        setter(name)(flipped[name])
        try:
            yield
        finally:
            # allow_tf32 rewrites the matmul precision, so the precision goes last
            m.allow_tf32, m.allow_bf16_reduced_precision_reduction, cudnn.allow_tf32 = saved[:3]
            torch.set_float32_matmul_precision(saved[3])

    out = {}
    for role, key in keys.items():
        base, out[role] = key(), {}
        for name in SWITCHES:
            with switched(name):
                differs = key() != base
            out[role][name] = {"differs": differs, "restored": key() == base}
    return out


def _port_main(tmp: Path) -> None:
    sys.path.insert(0, str(REPO))
    import torch

    from khmer_ocr_torch import cuda_graphs
    from khmer_ocr_torch.ops.kernels import build

    torch.set_num_threads(2)
    out = {"cache": _cache_cases(cuda_graphs.GraphCache), "bind": _bind_cases(torch, cuda_graphs.GraphCache),
           "capture": _capture_case(torch, cuda_graphs, build), "keys": _key_cases(torch)}
    (tmp / "out.json").write_text(json.dumps(out))


if __name__ == "__main__":
    _port_main(Path(sys.argv[1]))
