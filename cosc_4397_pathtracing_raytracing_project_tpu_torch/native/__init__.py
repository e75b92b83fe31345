"""The port's native C++ host runtime (``runtime``), built at first use."""
