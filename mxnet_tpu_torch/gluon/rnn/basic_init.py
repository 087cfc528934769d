"""String -> Initializer resolution shared by the gluon recurrent layers,
through :func:`...initializer.create`."""
from ...initializer import create as init_by_name  # noqa: F401
