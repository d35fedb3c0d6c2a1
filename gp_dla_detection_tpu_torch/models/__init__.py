"""The learned GP quasar model."""

from .qso_model import GPModel

__all__ = ["GPModel"]
