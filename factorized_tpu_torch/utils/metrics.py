"""Regression, classification and multi-trait metrics and the
reference-format score printers (port of
``factorized_tpu/utils/metrics.py``).

``score_regression`` prints MAE, Pearson correlation, the 7-class
``mult_acc``, the weighted F1 of the rounded values, then the binary
confusion matrix, report and accuracy at a threshold;
``score_classification`` prints the confusion matrix, report and
accuracy of the argmax labels; ``score_multitrait`` the bracketed
per-trait ``mae: [..]``, ``corr: [..]`` and ``mult_acc: [..]`` lines.
All print in the lines the reference's
log scrapers parse and return the metrics as a dict. Plain numpy, no
sklearn.
"""

from __future__ import annotations

import sys

import numpy as np


def mae(predictions, y):
    return float(np.mean(np.absolute(np.asarray(predictions) - np.asarray(y))))


def pearson_corr(predictions, y):
    return float(np.corrcoef(np.asarray(predictions), np.asarray(y))[0][1])


def mult_acc(predictions, y):
    """Fraction of samples whose rounded prediction equals the rounded
    label, rounded to 5 decimals."""
    p = np.round(np.asarray(predictions))
    t = np.round(np.asarray(y))
    return round(float(np.sum(p == t)) / float(len(t)), 5)


def accuracy(y_true, y_pred):
    return float(np.mean(np.asarray(y_true) == np.asarray(y_pred)))


def confusion_matrix(y_true, y_pred, labels=None):
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    if labels is None:
        labels = np.unique(np.concatenate([y_true, y_pred]))
    labels = list(labels)
    idx = {l: i for i, l in enumerate(labels)}
    m = np.zeros((len(labels), len(labels)), dtype=np.int64)
    for t, p in zip(y_true, y_pred):
        m[idx[t], idx[p]] += 1
    return m, labels


def precision_recall_f1_support(y_true, y_pred, labels=None):
    """Per-class precision/recall/F1/support (sklearn semantics:
    0/0 -> 0)."""
    m, labels = confusion_matrix(y_true, y_pred, labels)
    tp = np.diag(m).astype(np.float64)
    pred_tot = m.sum(axis=0).astype(np.float64)
    true_tot = m.sum(axis=1).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        precision = np.where(pred_tot > 0, tp / pred_tot, 0.0)
        recall = np.where(true_tot > 0, tp / true_tot, 0.0)
        denom = precision + recall
        f1 = np.where(denom > 0, 2 * precision * recall / denom, 0.0)
    return precision, recall, f1, true_tot.astype(np.int64), labels


def f1_weighted(y_true, y_pred):
    """Weighted-average F1 over the union of observed labels, as
    ``sklearn.f1_score(average='weighted')``."""
    _, _, f1, support, _ = precision_recall_f1_support(y_true, y_pred)
    total = support.sum()
    if total == 0:
        return 0.0
    return float(np.sum(f1 * support) / total)


def classification_report(y_true, y_pred, digits=5):
    """sklearn-shaped text report; log scrapers parse its
    ``weighted avg`` row."""
    precision, recall, f1, support, labels = precision_recall_f1_support(
        y_true, y_pred)
    total = int(support.sum())
    width = max(len(str(l)) for l in labels + ["weighted avg"])
    head_fmt = "{:>{width}} " + " {:>9}" * 4
    row_fmt = "{:>{width}} " + " {:>9.{digits}f}" * 3 + " {:>9}"
    lines = [head_fmt.format("", "precision", "recall", "f1-score",
                             "support", width=width), ""]
    for i, l in enumerate(labels):
        lines.append(row_fmt.format(str(l), precision[i], recall[i], f1[i],
                                    int(support[i]), width=width,
                                    digits=digits))
    lines.append("")
    acc_fmt = "{:>{width}} " + " {:>9}" * 2 + " {:>9.{digits}f}" + " {:>9}"
    lines.append(acc_fmt.format("accuracy", "", "", accuracy(y_true, y_pred),
                                total, width=width, digits=digits))
    w = support / max(total, 1)
    for name, vec in (
        ("macro avg", (precision.mean(), recall.mean(), f1.mean())),
        ("weighted avg",
         ((precision * w).sum(), (recall * w).sum(), (f1 * w).sum())),
    ):
        lines.append(row_fmt.format(name, *vec, total, width=width,
                                    digits=digits))
    return "\n".join(lines)


def _binary(predictions, y_test, binary_threshold, threshold_mode):
    if threshold_mode == "ge":
        return y_test >= binary_threshold, predictions >= binary_threshold
    return y_test > binary_threshold, predictions > binary_threshold


def regression_metrics(predictions, y_test, binary_threshold=0.0,
                       threshold_mode="ge"):
    """All regression metrics as a dict (for JSONL logging)."""
    predictions = np.asarray(predictions)
    y_test = np.asarray(y_test)
    true_label, predicted_label = _binary(predictions, y_test,
                                          binary_threshold, threshold_mode)
    return {
        "mae": mae(predictions, y_test),
        "corr": pearson_corr(predictions, y_test),
        "mult_acc": mult_acc(predictions, y_test),
        # the reference's call order: f1_score(round(pred), round(y))
        "mult_f_score": round(
            f1_weighted(np.round(predictions), np.round(y_test)), 5),
        "binary_accuracy": accuracy(true_label, predicted_label),
        "binary_f1": f1_weighted(true_label, predicted_label),
    }


def score_regression(predictions, y_test, binary_threshold=0.0,
                     threshold_mode="ge", out=None):
    """Print the reference-format regression score block and return the
    metrics dict."""
    out = out or sys.stdout
    predictions = np.asarray(predictions)
    y_test = np.asarray(y_test)
    if not np.isfinite(predictions).all():
        print("predictions non-finite (diverged run) - skipping score",
              file=out)
        return {k: float("nan") for k in
                ("mae", "corr", "mult_acc", "mult_f_score",
                 "binary_accuracy", "binary_f1")}
    m = regression_metrics(predictions, y_test, binary_threshold,
                           threshold_mode)
    true_label, predicted_label = _binary(predictions, y_test,
                                          binary_threshold, threshold_mode)
    cm, _ = confusion_matrix(true_label, predicted_label)
    print("mae: ", m["mae"], file=out)
    print("corr: ", m["corr"], file=out)
    print("mult_acc: ", m["mult_acc"], file=out)
    print("mult f_score: ", m["mult_f_score"], file=out)
    print("Confusion Matrix :", file=out)
    print(cm, file=out)
    print("Classification Report :", file=out)
    print(classification_report(true_label, predicted_label), file=out)
    print("Accuracy ", m["binary_accuracy"], file=out)
    out.flush()
    return m


def classification_metrics(logits_or_labels, y_test):
    """argmax if 2-D; returns accuracy + weighted f1."""
    pred = np.asarray(logits_or_labels)
    if pred.ndim == 2:
        pred = np.argmax(pred, axis=1)
    y_test = np.asarray(y_test)
    return {
        "accuracy": accuracy(y_test, pred),
        "f1_weighted": f1_weighted(y_test, pred),
    }


def score_classification(predictions, y_test, out=None):
    """Print the reference-format classification score block and return
    the metrics dict."""
    out = out or sys.stdout
    pred = np.asarray(predictions)
    if not np.isfinite(pred).all():
        print("predictions non-finite (diverged run) - skipping score",
              file=out)
        return {"accuracy": float("nan"), "f1_weighted": float("nan")}
    if pred.ndim == 2:
        pred = np.argmax(pred, axis=1)
    y_test = np.asarray(y_test)
    m = classification_metrics(pred, y_test)
    cm, _ = confusion_matrix(y_test, pred)
    print("Confusion Matrix :", file=out)
    print(cm, file=out)
    print("Classification Report :", file=out)
    print(classification_report(y_test, pred), file=out)
    print("Accuracy ", m["accuracy"], file=out)
    out.flush()
    return m


def multitrait_metrics(predictions, y_test):
    """Per-trait regression metrics for multi-trait datasets (the
    reference's POM/IEMOCAP experiments, whose logs ``check.py:128-164``
    aggregates): per-column mae / Pearson corr / round-and-compare
    mult_acc over a (n, n_traits) prediction matrix."""
    p = np.asarray(predictions)
    y = np.asarray(y_test)
    return {
        "mae": [mae(p[:, i], y[:, i]) for i in range(y.shape[1])],
        "corr": [pearson_corr(p[:, i], y[:, i]) for i in range(y.shape[1])],
        "mult_acc": [mult_acc(p[:, i], y[:, i]) for i in range(y.shape[1])],
    }


def score_multitrait(predictions, y_test, out=None):
    """Print the bracketed multi-trait log lines the reference's
    ``check.py`` POM/IEMOCAP modes regex-parse (``check.py:132-140``:
    ``mae: [..]`` with no 'test' in the line, ``corr: [..]``,
    ``mult_acc: [..]``) and return the per-trait metrics dict."""
    out = out or sys.stdout
    p = np.asarray(predictions)
    if not np.isfinite(p).all():
        print("predictions non-finite (diverged run) - skipping score",
              file=out)
        nan_row = [float("nan")] * np.asarray(y_test).shape[1]
        return {"mae": nan_row, "corr": nan_row, "mult_acc": nan_row}
    m = multitrait_metrics(p, y_test)
    print("mae:", [round(v, 5) for v in m["mae"]], file=out)
    print("corr:", [round(v, 5) for v in m["corr"]], file=out)
    print("mult_acc:", [round(v, 5) for v in m["mult_acc"]], file=out)
    out.flush()
    return m
