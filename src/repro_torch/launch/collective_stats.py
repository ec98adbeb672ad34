"""The collective ledger under the launch layer, where its JAX twin
``repro.launch.hlo_stats`` lives: a re-export of
:mod:`repro_torch.core.collective_stats`, which the shuffle executors
feed as they run."""

from ..core.collective_stats import CollectiveStats, note, record_collectives

__all__ = ["CollectiveStats", "record_collectives", "note"]
