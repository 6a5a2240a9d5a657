from . import timing, export, checkpointing
