"""Data substrate: query streams, behaviour profiles, tokenizer, RouterBench."""
from repro_torch.data import profiles, routerbench, stream, tokenizer
from repro_torch.data.profiles import (ENERGY_SCALE_WH, OutcomeSimulator,
                                       mean_accuracy, mean_energy_mwh)
from repro_torch.data.stream import labeled_sample, make_query, make_stream

__all__ = ["profiles", "routerbench", "stream", "tokenizer",
           "ENERGY_SCALE_WH", "OutcomeSimulator", "mean_accuracy",
           "mean_energy_mwh", "labeled_sample", "make_query", "make_stream"]
