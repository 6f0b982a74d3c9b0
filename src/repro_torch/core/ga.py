"""Generic genetic algorithm (paper §3.1).

The paper's automatic offloading encodes "offload this loop to GPU?" as a
bitstring gene and evolves it against measured performance in a verification
environment.  We reproduce the GA generically (integer genes with per-locus
alphabets, so both bitstrings and categorical choices work) and re-target it
in `core.shard_search` at the accelerator decision space — sharding axes,
microbatch, loss chunking — with the roofline model as the fitness oracle.
The port's own copy of `repro.core.ga`: pure numpy and the same code, so
the same rng gives the same search.

Deterministic given the rng; fitness is maximized.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

Gene = Tuple[int, ...]


@dataclasses.dataclass
class GaConfig:
    population: int = 24
    generations: int = 20
    crossover_rate: float = 0.9
    mutation_rate: float = 0.05       # per locus
    elite: int = 2
    tournament: int = 3


@dataclasses.dataclass
class GaResult:
    best_gene: Gene
    best_fitness: float
    history: List[float]              # best fitness per generation
    evaluations: int


class GeneticSearch:
    """GA over integer genes; ``alphabet[i]`` = #choices at locus i."""

    def __init__(
        self,
        alphabet: Sequence[int],
        fitness: Callable[[Gene], float],
        config: Optional[GaConfig] = None,
        rng: Optional[np.random.Generator] = None,
    ) -> None:
        if any(a < 1 for a in alphabet):
            raise ValueError("alphabet entries must be ≥ 1")
        self.alphabet = tuple(int(a) for a in alphabet)
        self.fitness_fn = fitness
        self.cfg = config or GaConfig()
        self.rng = rng or np.random.default_rng(0)
        self._cache: Dict[Gene, float] = {}
        self.evaluations = 0

    # ------------------------------------------------------------ plumbing
    def _random_gene(self) -> Gene:
        return tuple(int(self.rng.integers(a)) for a in self.alphabet)

    def _eval(self, gene: Gene) -> float:
        if gene not in self._cache:
            self._cache[gene] = float(self.fitness_fn(gene))
            self.evaluations += 1
        return self._cache[gene]

    def _tournament(self, pop: List[Gene], fit: List[float]) -> Gene:
        idx = self.rng.integers(len(pop), size=self.cfg.tournament)
        best = max(idx, key=lambda i: fit[int(i)])
        return pop[int(best)]

    def _crossover(self, a: Gene, b: Gene) -> Gene:
        mask = self.rng.random(len(a)) < 0.5
        return tuple(int(x if m else y) for x, y, m in zip(a, b, mask))

    def _mutate(self, g: Gene) -> Gene:
        out = list(g)
        for i, a in enumerate(self.alphabet):
            if a > 1 and self.rng.random() < self.cfg.mutation_rate:
                out[i] = int(self.rng.integers(a))
        return tuple(out)

    # ---------------------------------------------------------------- run
    def run(self, seed_genes: Sequence[Gene] = ()) -> GaResult:
        cfg = self.cfg
        pop: List[Gene] = list(seed_genes)[: cfg.population]
        while len(pop) < cfg.population:
            pop.append(self._random_gene())
        history: List[float] = []
        for _ in range(cfg.generations):
            fit = [self._eval(g) for g in pop]
            order = np.argsort(fit)[::-1]
            history.append(fit[int(order[0])])
            new_pop: List[Gene] = [pop[int(i)] for i in order[: cfg.elite]]
            while len(new_pop) < cfg.population:
                pa = self._tournament(pop, fit)
                if self.rng.random() < cfg.crossover_rate:
                    pb = self._tournament(pop, fit)
                    child = self._crossover(pa, pb)
                else:
                    child = pa
                new_pop.append(self._mutate(child))
            pop = new_pop
        fit = [self._eval(g) for g in pop]
        best_i = int(np.argmax(fit))
        return GaResult(pop[best_i], fit[best_i], history, self.evaluations)
