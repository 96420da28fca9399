"""Tiny widths of the benchmark's cells for tests on the CPU: every key
the cells' files give, the widths cut to a few dozen."""

from harness import spec

TRAIN_CELL = "mixtral8x7b-l4_train_s4096"
SERVE_CELLS = ("mistral7b_serve_chat", "mistral7b_serve_longprompt")


def train_cell():
    cell = spec.load_cell(TRAIN_CELL)
    cell.config = dict(cell.config, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                       num_attention_heads=4, num_key_value_heads=2, num_local_experts=4,
                       vocab_size=256)
    cell.traffic = dict(cell.traffic, seq_len=64, batch=2)
    return cell


def serve_cell(name):
    cell = spec.load_cell(name)
    cell.config = dict(cell.config, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                       num_attention_heads=4, num_key_value_heads=2, vocab_size=256,
                       deployment=dict(cell.config["deployment"], slots=4, pages_per_slot=16))
    t = cell.traffic
    cell.traffic = dict(t, clients=4, ramp_s=0.2, block=4, check_tokens=20,
                        prompt_len=dict(t["prompt_len"], min=4, max=120, median=16),
                        output_len=dict(t["output_len"], min=2, max=12, median=6))
    if t["prompt_len"]["dist"] == "uniform":
        cell.traffic["prompt_len"] = dict(t["prompt_len"], min=100, max=200)
        cell.traffic["output_len"] = dict(t["output_len"], min=2, max=8)
    return cell
