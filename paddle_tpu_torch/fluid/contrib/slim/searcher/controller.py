"""Search controllers (ref: contrib/slim/searcher/controller.py).

Token-space controllers for architecture/ratio search: a token list
indexes a user-defined range table; the controller proposes the next
token list and learns from rewards. SAController is the stock simulated
annealing implementation the reference ships.

Port of paddle_tpu/fluid/contrib/slim/searcher/controller.py. It draws
from Python's global ``random``, so a seeded run proposes the same
tokens in both packages.
"""
import copy
import math
import random

__all__ = ["EvolutionaryController", "SAController"]


class EvolutionaryController:
    """ref controller.py:28 — the controller protocol."""

    def __init__(self, *args, **kwargs):
        pass

    def update(self, tokens, reward):
        raise NotImplementedError("'update' is not implemented")

    def reset(self, range_table, constrain_func=None):
        raise NotImplementedError("'reset' is not implemented")

    def next_tokens(self):
        raise NotImplementedError("'next_tokens' is not implemented")


class SAController(EvolutionaryController):
    """Simulated annealing (ref controller.py:59): accept a worse
    candidate with prob exp((reward - best) / temperature); temperature
    decays by reduce_rate per update."""

    def __init__(self, range_table=None, reduce_rate=0.85,
                 init_temperature=1024, max_iter_number=300):
        super().__init__()
        self._range_table = list(range_table or [])
        self._reduce_rate = float(reduce_rate)
        self._init_temperature = float(init_temperature)
        self._max_iter_number = int(max_iter_number)
        self._temperature = self._init_temperature
        self._tokens = None
        self._reward = -float("inf")
        self._best_tokens = None
        self._max_reward = -float("inf")
        self._iter = 0
        self._constrain_func = None

    def reset(self, range_table, init_tokens, constrain_func=None):
        self._range_table = list(range_table)
        self._tokens = list(init_tokens)
        self._constrain_func = constrain_func
        self._temperature = self._init_temperature
        self._reward = -float("inf")
        self._best_tokens = list(init_tokens)
        self._max_reward = -float("inf")
        self._iter = 0

    def update(self, tokens, reward):
        """Accept/reject `tokens` given its measured `reward`."""
        self._iter += 1
        self._temperature *= self._reduce_rate
        if reward > self._reward or random.random() < math.exp(
                min((reward - self._reward) / max(self._temperature, 1e-9),
                    0.0)):
            self._reward = reward
            self._tokens = list(tokens)
        if reward > self._max_reward:
            self._max_reward = reward
            self._best_tokens = list(tokens)

    def next_tokens(self, control_token=None):
        """Perturb one position of the current tokens (or the provided
        control_token) within the range table; retries until the
        constraint accepts, like the reference."""
        base = list(control_token) if control_token else list(self._tokens)
        for _ in range(10000):
            cand = copy.deepcopy(base)
            i = random.randrange(len(cand))
            cand[i] = random.randrange(self._range_table[i])
            if self._constrain_func is None or self._constrain_func(cand):
                return cand
        raise RuntimeError(
            "SAController: constrain_func rejected 10000 candidates"
        )

    @property
    def best_tokens(self):
        return list(self._best_tokens or [])

    @property
    def max_reward(self):
        return self._max_reward
