from .demod_triton import century_stats

__all__ = ["century_stats"]
