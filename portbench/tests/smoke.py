"""Small sizes at which the CPU tests run the cells: the port's smoke
configurations (f32) and short traffic."""

MODEL = {
    "mamba2-370m": {"n_layers": 3, "d_model": 64, "ssm_state": 16,
                    "ssm_head_dim": 16, "ssm_chunk": 8, "vocab_size": 503,
                    "dtype": "float32", "param_dtype": "float32"},
    "hymba-1.5b": {"n_layers": 3, "d_model": 64, "n_heads": 5,
                   "n_kv_heads": 5, "head_dim": 8, "d_ff": 160,
                   "vocab_size": 503, "sliding_window": 16, "ssm_state": 8,
                   "ssm_head_dim": 16, "ssm_chunk": 8, "dtype": "float32",
                   "param_dtype": "float32"},
}
MODEL["mamba2-370m-plainssd"] = MODEL["mamba2-370m"]
MIX = {
    "train": {"batch": 2, "seq_len": 32, "corpus_batches": 16},
    "prefill": {"batch": 4, "prompt_len": 32, "store_docs": 64,
                "check_requests": 8},
}


def overrides(cell_name: str):
    """(model override, mix override) of a cell at the smoke size."""
    from portbench import cells
    cell = cells.load_cell(cell_name)
    return MODEL[cell["config"]], MIX[cell["mix"]["job"]]


def run(cell_name: str, seed: int = 1234567890123, seconds: float = 0.5,
        trace: bool = False, device: str = "cpu"):
    from portbench import harness
    model, mix = overrides(cell_name)
    return harness.run_cell(cell_name, seed, seconds, trace, device=device,
                            model_override=model, mix_override=mix)
