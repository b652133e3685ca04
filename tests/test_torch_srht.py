"""One SRHT SAFL round of the port against the reference.

bert_100m SMOKE, the same weights, batch and key in both packages; the
port's kernel route (the FWHT kernel's plain version on the CPU) against
the reference's plain route.  Tolerances as in tests/test_torch_safl.py.
"""

import torch

from repro.configs import bert_100m as rbert
from repro_torch.configs import bert_100m as tbert
from test_torch_round import one_round
from torch_priority import lower_priority  # noqa: F401 (autouse)

torch.set_num_threads(2)



def test_srht_round_matches_reference():
    one_round(rbert.SMOKE.vocab_size, rbert.SMOKE, tbert.SMOKE, 4,
              kind="srht")
