"""The flags a port CLI's main() defines when it runs, dropped again.

export_cli.main defines its own flags in the port's registry, as the JAX
package's CLI does, and they stay there after it returns.  A test file
that runs it drops them after each test (`drop_export_cli_flags`), so that
what runs next in the worker sees the registry that the port's modules
define at import.  The names are read from export_cli.define_flags itself.
"""

from __future__ import annotations

from pocketflow_tpu_torch.config import FLAGS, FlagRegistry


def export_cli_flags():
    """The names export_cli.main defines, in the order it defines them."""
    from pocketflow_tpu_torch.tools import export_cli
    scratch = FlagRegistry()
    export_cli.define_flags(scratch)
    return tuple(scratch._specs)


def drop_export_cli_flags(registry=FLAGS):
    """Take export_cli.main's flags out of `registry`."""
    for name in export_cli_flags():
        registry._specs.pop(name, None)
        registry._values.pop(name, None)
