from .beam import (BeamConfig, beam_search, beam_texts,  # noqa: F401
                   beam_top_select, beam_top_texts)
from .topp import ToppConfig, greedy_topp_search, topp_texts  # noqa: F401
