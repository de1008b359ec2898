"""Abstract model protocol (port of ``landhydrology_tpu/models/base.py``)."""

from __future__ import annotations


class AbstractModel:
    """Base class for models: frozen dataclasses whose fields select the
    functions ``make_rhs(model)`` builds.  Subclasses implement
    :meth:`default_initial_conditions` or raise."""

    #: name under which prognostic state is nested in the state dict
    name: str = "model"

    def default_initial_conditions(self):
        raise NotImplementedError(
            "No default initial conditions exist for this model type."
        )
