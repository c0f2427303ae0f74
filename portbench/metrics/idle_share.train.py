"""% of the traced stretch with no kernel on the device (copies idle)."""

from portbench.readers import idle_share as read  # noqa: F401
