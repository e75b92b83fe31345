from .timing import current_time_string

__all__ = ["current_time_string"]
