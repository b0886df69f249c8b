"""The busiest expert's token slots over the mean expert's, in the MoE
layer where that ratio is largest, over the window's steps: the program's
counter ``models/moe.py:expert_tokens`` (slots by layer and expert,
accumulated on the device, zeroed at the end of set-up), read once after
the window. None where the program has no such counter or counted
nothing."""


def read(run, params):
    try:
        from topiaxl_torch.models.moe import read_expert_tokens
    except ImportError:
        return None
    ratios = [max(c) * len(c) / sum(c)
              for c in read_expert_tokens().values() if sum(c)]
    return max(ratios) if ratios else None
