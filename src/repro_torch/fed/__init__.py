"""Client participation and robustness: sampling policies whose per-round
cohort mask the round functions take as ``part_mask``, the async staleness
buffer, deterministic fault injection, sketch-space payload sentinels and
the quantized payload codec (int8 / 1-bit stochastic rounding with
sketch-space error feedback and measured ``uplink_bits``)."""

from repro_torch.fed.async_buffer import (AsyncConfig, arrival_weight,
                                          init_async_state, make_async_round)
from repro_torch.fed.codec import (CodecConfig, encode_decode,
                                   init_codec_state, measured_uplink_bits)
from repro_torch.fed.faults import (BYZANTINE, DROP, INF, NAN, OK, FaultConfig,
                                    FaultTable, corrupt_payload, fold_arrivals,
                                    take_rows)
from repro_torch.fed.participation import (AvailabilityTrace, FixedCohort,
                                           FullParticipation,
                                           ImportanceParticipation,
                                           UniformParticipation,
                                           check_policy_clients,
                                           is_weighted_mask, masked_mean,
                                           masked_mean_tree, round_variates)
from repro_torch.fed.robust import (SentinelConfig, carry_if_empty,
                                    divergence_flag, guard_uplink,
                                    masked_median, sentinel_validity)
