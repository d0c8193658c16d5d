"""MovieLens-1M reader (ref: python/paddle/dataset/movielens.py). Yields
(user_id, gender_id, age_id, job_id, movie_id, category_ids, title_ids,
rating) — the schema the reference's recommender chapter trains on. A
deterministic synthetic catalogue stands in without local files."""
import numpy as np

__all__ = [
    "train", "test", "get_movie_title_dict", "max_movie_id", "max_user_id",
    "max_job_id", "age_table", "movie_categories", "user_info", "movie_info",
]

age_table = [1, 18, 25, 35, 45, 50, 56]

_N_USERS = 500
_N_MOVIES = 400
_N_CATS = 18
_TITLE_VOCAB = 300
_N_JOBS = 21


class MovieInfo:
    def __init__(self, movie_id, categories, title_ids):
        self.index = movie_id
        self.categories = categories
        self.title = title_ids


class UserInfo:
    def __init__(self, user_id, gender, age_idx, job_id):
        self.index = user_id
        self.is_male = gender == 0
        self.age = age_table[age_idx]
        self.job_id = job_id


def _catalogue():
    rng = np.random.default_rng(11)
    movies = {}
    for m in range(1, _N_MOVIES + 1):
        cats = rng.choice(_N_CATS, size=rng.integers(1, 4), replace=False)
        title = rng.integers(1, _TITLE_VOCAB, size=rng.integers(2, 6))
        movies[m] = MovieInfo(m, list(map(int, cats)), list(map(int, title)))
    users = {}
    for u in range(1, _N_USERS + 1):
        users[u] = UserInfo(
            u, int(rng.integers(0, 2)), int(rng.integers(0, len(age_table))),
            int(rng.integers(0, _N_JOBS)),
        )
    return movies, users


_MOVIES, _USERS = _catalogue()


def _ratings(split):
    rng = np.random.default_rng(5 if split == "train" else 6)
    n = 4000 if split == "train" else 800
    for _ in range(n):
        u = int(rng.integers(1, _N_USERS + 1))
        m = int(rng.integers(1, _N_MOVIES + 1))
        user, movie = _USERS[u], _MOVIES[m]
        # rating correlates with (user, movie) hash → learnable signal
        base = ((u * 2654435761 + m * 40503) >> 8) % 5
        rating = float(min(5, max(1, base + int(rng.integers(0, 2)))))
        yield (
            u, int(not user.is_male), age_table.index(user.age), user.job_id,
            m, movie.categories, movie.title, rating,
        )


def train():
    return lambda: _ratings("train")


def test():
    return lambda: _ratings("test")


def max_user_id():
    return _N_USERS


def max_movie_id():
    return _N_MOVIES


def max_job_id():
    return _N_JOBS - 1


def movie_categories():
    return ["cat%d" % i for i in range(_N_CATS)]


def get_movie_title_dict():
    return {"w%d" % i: i for i in range(_TITLE_VOCAB)}


def movie_info():
    return dict(_MOVIES)


def user_info():
    return dict(_USERS)
