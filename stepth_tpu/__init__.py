"""Former name of the :mod:`stepth` package, kept as an alias.

Importing this package, or any submodule under it, gives the very module of
:mod:`stepth` with the same path: ``<this>.models.StereoModel is
stepth.models.StereoModel``. New code imports :mod:`stepth`.
"""

import importlib
import importlib.abc
import importlib.util
import sys
import warnings

from stepth import *  # noqa: F401,F403
from stepth import __all__, __version__  # noqa: F401

_PREFIX = __name__ + "."


class _AliasFinder(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """Resolves ``<this>.X`` to the module ``stepth.X`` (one module object
    under both names, so classes and caches are shared)."""

    def find_spec(self, name, path=None, target=None):
        if name.startswith(_PREFIX):
            return importlib.util.spec_from_loader(name, self)
        return None

    def create_module(self, spec):
        return None

    def exec_module(self, module):
        # the import system returns whatever sys.modules holds after exec
        real = importlib.import_module("stepth." + module.__name__[len(_PREFIX):])
        sys.modules[module.__name__] = real


if not any(type(f).__qualname__ == "_AliasFinder" for f in sys.meta_path):
    sys.meta_path.insert(0, _AliasFinder())

warnings.warn(
    f"the package {__name__!r} is now 'stepth'; import stepth instead",
    DeprecationWarning,
    stacklevel=2,
)
