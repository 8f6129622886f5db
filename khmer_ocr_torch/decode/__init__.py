from .beam import beam_decode, topk_iter
from .greedy import greedy_decode

__all__ = ["beam_decode", "greedy_decode", "topk_iter"]
