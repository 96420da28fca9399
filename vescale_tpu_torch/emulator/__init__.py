"""The collective emulator: deterministic single-process replay of
collectives (the port of ``vescale_tpu/emulator/``)."""

from . import mesh_collectives
from .core import Emulator, EmulatorProcessGroup, init_process_group
from .quantized import quantized_all_reduce, quantized_reduce_scatter, quantized_ring_report
from .tuning import LinkParams, calculate_chunk_size, choose_algorithm, estimate_time_us
from .verify import verify_all_reduce_against_backend

__all__ = ["Emulator", "EmulatorProcessGroup", "init_process_group", "mesh_collectives",
           "quantized_all_reduce", "quantized_reduce_scatter", "quantized_ring_report",
           "LinkParams", "calculate_chunk_size", "choose_algorithm", "estimate_time_us",
           "verify_all_reduce_against_backend"]
