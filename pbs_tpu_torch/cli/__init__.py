"""The port's command line (``pbst-torch``).

``main`` is loaded on first use, so ``python -m pbs_tpu_torch.cli.pbst``
runs the module once, as ``__main__``, instead of after its package
init had already imported it.
"""

__all__ = ["main"]


def __getattr__(name: str):
    if name == "main":
        from pbs_tpu_torch.cli.pbst import main

        return main
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
