"""Plain reference of ``evflownet.json``: EV-FlowNet (Zhu et al., RSS
2018, arXiv:1802.06898) on the learnable event representation."""
import torch.nn as nn

from harness.reference.layers import (Predictor, Representation,
                                    predicted_windows)


class Model(nn.Module):

    def __init__(self, config, rnd):
        super().__init__()
        flags, sizes = config['flags'], config['model']
        depth = flags['--event-representation-depth']
        self.elements = flags['--max-sequence-length']
        self.prefix = flags.get('--prefix-length', 0)
        self.shape = (flags['--height'], flags['--width'])
        self.quantization_layer = Representation(
            depth, sizes['kernel_mlp_hidden'], rnd)
        self.predictor = Predictor(depth * self.elements,
                                   sizes['base_channels'], rnd)

    def dense(self, grid):
        """The network after the representation: flows, coarse first."""
        return self.predictor(grid)

    def forward(self, batch):
        grid = self.quantization_layer(batch, self.elements, self.shape)
        return (self.dense(grid),) + predicted_windows(batch, self.prefix)


def build(config, rnd):
    return Model(config, rnd)
