"""Tiny cells for the CPU tests: each cell of BENCHMARK.json with its own
traffic, driver and limits, at a size a test run holds."""
import copy

from portbench.harness import ROOT, Cell, _load

TINY = {"name": "tiny", "source": "tests", "num_hidden_layers": 2,
        "hidden_size": 32, "num_attention_heads": 4, "num_key_value_heads": 4,
        "intermediate_size": 48, "vocab_size": 20, "rms_norm_eps": 1e-6,
        "rope_theta": 10000.0, "tie_word_embeddings": False,
        "torch_dtype": "float32"}
TINY_BF16 = dict(TINY, hidden_size=64, intermediate_size=96, vocab_size=64,
                 tie_word_embeddings=True, torch_dtype="bfloat16")


def tiny_call(call: dict) -> dict:
    """A simulator's window call cut to a few events, its bound kept."""
    if "max_time" in call:
        return {"max_time": 4.0, "eval_every": 2}
    return {"max_events": 2, "eval_every": 2}


def tiny_cell(workload: str) -> Cell:
    """The cell ``workload`` cut to 8 simulated workers of a 2-layer,
    32-wide decoder on 2 × 16 characters, or to 4 training workers of a
    2-layer, 64-wide bf16 decoder on 64 tokens."""
    cell = Cell(_load(ROOT / "BENCHMARK.json"), workload)
    tr = copy.deepcopy(cell.traffic)
    if tr["driver"] == "sim":
        tr.update(workers=8, call=tiny_call(tr["call"]))
        tr["data"].update(pool=2, batch=2, seq_len=16, eval_batch=4)
        cell.config = dict(TINY)
    else:
        tr.update(workers=4, seq_len=64, logit_chunk=16, max_window_steps=4)
        cell.config = dict(TINY_BF16)
    cell.traffic = tr
    return cell
