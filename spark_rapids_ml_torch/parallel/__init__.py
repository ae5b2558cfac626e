from .context import (  # noqa: F401
    DeviceContext,
    get_default_device,
    resolve_device,
    set_default_device,
)
from .mesh import RowStager  # noqa: F401
