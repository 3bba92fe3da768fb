"""The ragged expert FFN's share of the device's busy time (offline
traffic); its GEMMs are the only grouped GEMMs the dropless engine runs."""
from bench.core.readers import EXPERT_FFN, named, share_of_busy


def read(ctx):
    return share_of_busy(ctx, named(*EXPERT_FFN))
