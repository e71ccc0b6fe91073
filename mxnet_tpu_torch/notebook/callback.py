"""Notebook training callbacks (counterpart of
`mxnet_tpu/notebook/callback.py`; reference: python/mxnet/notebook/
callback.py). `PandasLogger` records train/eval/epoch metrics into pandas
DataFrames through the standard fit() callback slots, where pandas is
installed (building one without it raises `ImportError` naming pandas);
the Live*Chart family needs bokeh and raises with a clear message instead
of half-rendering."""
from __future__ import annotations

import datetime
import time

try:
    import pandas as pd
except ImportError:
    pd = None

__all__ = ["PandasLogger", "LiveBokehChart", "LiveLearningCurve"]


class PandasLogger:
    """reference: notebook/callback.py:71 — three DataFrames (train,
    eval, epoch); wire in with ``model.fit(**logger.callback_args())``."""

    def __init__(self, batch_size, frequent=50):
        if pd is None:
            raise ImportError("PandasLogger needs pandas, which is not "
                              "installed")
        self.batch_size = batch_size
        self.frequent = frequent
        self._dataframes = {"train": pd.DataFrame(),
                            "eval": pd.DataFrame(),
                            "epoch": pd.DataFrame()}
        self.last_time = time.time()
        self.start_time = datetime.datetime.now()
        self.last_epoch_time = datetime.datetime.now()

    @property
    def train_df(self):
        return self._dataframes["train"]

    @property
    def eval_df(self):
        return self._dataframes["eval"]

    @property
    def epoch_df(self):
        return self._dataframes["epoch"]

    @property
    def all_dataframes(self):
        return self._dataframes

    def elapsed(self):
        return datetime.datetime.now() - self.start_time

    def append_metrics(self, metrics, df_name):
        df = self._dataframes[df_name]
        for col in set(metrics) - set(df.columns):
            df[col] = None
        df.loc[len(df)] = metrics

    def train_cb(self, param):
        if param.nbatch % self.frequent == 0:
            self._process_batch(param, "train")

    def eval_cb(self, param):
        self._process_batch(param, "eval")

    def _process_batch(self, param, df_name):
        now = time.time()
        if param.eval_metric is not None:
            metrics = dict(param.eval_metric.get_name_value())
            param.eval_metric.reset()
        else:
            metrics = {}
        try:
            speed = self.frequent / (now - self.last_time)
        except ZeroDivisionError:
            speed = float("inf")
        metrics["batches_per_sec"] = speed * self.batch_size
        metrics["records_per_sec"] = speed
        metrics["elapsed"] = self.elapsed()
        metrics["minibatch_count"] = param.nbatch
        metrics["epoch"] = param.epoch
        self.append_metrics(metrics, df_name)
        self.last_time = now

    def epoch_cb(self):
        now = datetime.datetime.now()
        self.append_metrics({"elapsed": self.elapsed(),
                             "epoch_time": now - self.last_epoch_time},
                            "epoch")
        self.last_epoch_time = now

    def callback_args(self):
        """kwargs for model.fit() wiring all three callbacks."""
        return {"batch_end_callback": self.train_cb,
                "eval_end_callback": self.eval_cb,
                "epoch_end_callback": self.epoch_cb}


def _needs_bokeh(name):
    raise ImportError(
        "%s renders live bokeh charts in a notebook; bokeh is not "
        "installed. PandasLogger records the same metrics into DataFrames "
        "for offline plotting." % name)


class LiveBokehChart:
    """reference: notebook/callback.py:204 — requires bokeh."""

    def __init__(self, *args, **kwargs):
        _needs_bokeh("LiveBokehChart")


class LiveLearningCurve(LiveBokehChart):
    """reference: notebook/callback.py — requires bokeh."""

    def __init__(self, *args, **kwargs):
        _needs_bokeh("LiveLearningCurve")
