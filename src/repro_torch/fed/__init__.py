"""Client participation: sampling policies whose per-round cohort mask the
round functions take as ``part_mask``.  (The reference's async buffers,
faults, sentinels and payload codec are not ported yet.)"""

from repro_torch.fed.participation import (AvailabilityTrace, FixedCohort,
                                           FullParticipation,
                                           ImportanceParticipation,
                                           UniformParticipation,
                                           check_policy_clients,
                                           is_weighted_mask, masked_mean,
                                           masked_mean_tree, round_variates)
