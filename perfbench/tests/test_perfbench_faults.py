'''A run with the timed path broken underneath comes out not correct:
each fault a cell can have, planted in the program, on the CPU at a test
size (the card's run compares the same numbers at the cell's size).  The
cells run on one chip, so no exchange between chips can be left out.'''

import pytest
import torch

SEED = 3141592653


def _render_unchanged(orig):
    def render(scene, film, start, spp=1, **kw):
        return film
    return render


def _render_half(orig):
    def render(scene, film, start, spp=1, **kw):
        tmp = orig(scene, torch.zeros_like(film), start, spp=spp, **kw)
        half = film.shape[2] // 2
        film[:, :, :half] += tmp[:, :, :half]
        return film
    return render


PROGRESSIVE = {'unchanged': _render_unchanged, 'half': _render_half}


def _half_mse(img, target):
    '''The loss's mean over half the pixels.'''
    target = torch.as_tensor(target, dtype=img.dtype)
    half = img.shape[0] // 2
    return torch.mean((img[:half] - target[:half]) ** 2)


@pytest.mark.parametrize('fault', sorted(PROGRESSIVE) + ['altered'])
def test_progressive_fault_is_not_correct(tiny_run, monkeypatch, fault):
    from ptina_tpu_torch.engine import path
    if fault == 'altered':  # a pixel's radiance altered where it is made
        add = path.film_add

        def film_add(film, p, r, g, b, w):
            return add(film, p, r.flip(0), g, b, w)
        monkeypatch.setattr(path, 'film_add', film_add)
    else:
        monkeypatch.setattr(path, 'render', PROGRESSIVE[fault](path.render))
    line = tiny_run('monkey.progressive', SEED)
    assert line['correct'] is False


def test_progressive_sound_is_correct(tiny_run):
    line = tiny_run('monkey.progressive', SEED)
    assert line['correct'] is True
    assert all(c['value'] == 0.0 for c in line['checks'].values())


@pytest.mark.parametrize('fault', ['unchanged', 'half', 'altered'])
def test_inverse_fault_is_not_correct(tiny_run, monkeypatch, fault):
    from ptina_tpu_torch import diff
    if fault == 'unchanged':  # a step that returns its state unchanged
        step = diff.inverse_render_step

        def inverse_render_step(scene, target, sample_index=0, spp=1,
                                lr=0.1):
            return scene, step(scene, target, sample_index, spp, lr)[1]
        monkeypatch.setattr(diff, 'inverse_render_step', inverse_render_step)
    elif fault == 'half':
        monkeypatch.setattr(diff, '_mse', _half_mse)
    else:  # the image's first row altered where it is made
        render = diff.render_image_diff

        def render_image_diff(*a, **kw):
            img = render(*a, **kw)
            return torch.cat([torch.zeros_like(img[:1]), img[1:]])
        monkeypatch.setattr(diff, 'render_image_diff', render_image_diff)
    line = tiny_run('monkey.inverse', SEED)
    assert line['correct'] is False


@pytest.mark.parametrize('fault', ['unchanged', 'half'])
def test_inverse_window_fault_is_not_correct(tiny_run, monkeypatch, fault):
    '''A fault in the window's steps alone, past the steps set-up drives
    and checks, is caught by the check of the window's last step.'''
    from perfbench.drivers import inverse
    from ptina_tpu_torch import diff
    step, calls = diff.inverse_render_step, [0]

    def inverse_render_step(scene, target, sample_index=0, spp=1, lr=0.1):
        calls[0] += 1
        if calls[0] <= inverse.CHECK_STEPS:
            return step(scene, target, sample_index, spp, lr)
        if fault == 'unchanged':
            return scene, step(scene, target, sample_index, spp, lr)[1]
        mse, diff._mse = diff._mse, _half_mse
        try:
            return step(scene, target, sample_index, spp, lr)
        finally:
            diff._mse = mse
    monkeypatch.setattr(diff, 'inverse_render_step', inverse_render_step)
    line = tiny_run('monkey.inverse', SEED)
    assert line['correct'] is False
    assert line['checks']['loss_gap']['value'] <= \
        line['checks']['loss_gap']['limit']


def test_inverse_sound_is_correct(tiny_run):
    line = tiny_run('monkey.inverse', SEED)
    assert line['correct'] is True

