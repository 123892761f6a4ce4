"""The hierarchical config/rendezvous store (the xenstore analog): the
port of ``pbs_tpu.store``."""

from pbs_tpu_torch.store.store import Store, Transaction, TransactionError

__all__ = ["Store", "Transaction", "TransactionError"]
