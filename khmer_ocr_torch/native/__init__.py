from .build import levenshtein_batch, load_native_library

__all__ = ["load_native_library", "levenshtein_batch"]
