"""The three walkthroughs, ported: ``train_from_text``, ``serving_stack``
and ``multi_tenant`` (the twins of ``examples/*.py``).

Each runs as ``python -m pbs_tpu_torch.examples.<name>`` on the card,
or on the host with ``--device cpu``. The reference's walkthroughs
default to the CPU; the twins default to the card, a stated departure
(every entry point of the port does).
"""
