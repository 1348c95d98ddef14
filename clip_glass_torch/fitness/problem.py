"""GenerationProblem: config -> population-fitness function + its search.

Behavioral reference: reference problem.py:7-29. With a mesh
(parallel.mesh) the evaluation splits the population's rows over it.
"""

from __future__ import annotations

from clip_glass_torch.fitness.generator import Generator


class GenerationProblem:
    def __init__(self, config, device=None, policy=None,
                 clip_weights: str = "random:0", clip_cfg=None, model_cfg=None,
                 bundle=None, mesh=None):
        self.config = config
        self.generator = Generator(config, device=device, policy=policy,
                                   clip_weights=clip_weights, clip_cfg=clip_cfg,
                                   model_cfg=model_cfg, bundle=bundle, mesh=mesh)

    @property
    def device(self):
        return self.generator.device

    @property
    def mesh(self):
        return self.generator.mesh

    def eval_fn(self):
        """(X [pop, n_var]) -> F [pop, n_obj] (minimized); with
        config.stochastic (X, seed) -> F, the seed the generation's own
        (evolve.algorithm.draw_seed)."""
        gen = self.generator
        if self.config.stochastic:
            return lambda X, seed: gen.eval_population(X, seed=seed)
        return gen.eval_population

    def make_algorithm(self):
        from clip_glass_torch.evolve.algorithm import make_algorithm
        return make_algorithm(self.config, self.eval_fn(), self.device)
