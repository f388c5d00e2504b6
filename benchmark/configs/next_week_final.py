"""The Next Week's final scene (§10 of the book, ``final_scene(800, 10000,
40)``), as a plain recipe: 20×20 ground boxes whose heights draw from
``numpy.random.default_rng(seed)``, a light quad, a moving sphere, glass
and fuzzy-metal spheres, a glass sphere filled with a blue medium, a
fog around everything, an earth (the configuration's ``image``), a
marble sphere and 1,000 white spheres whose centres draw from the same
generator after the heights. The book turns the white cluster by
``rotate_y(15)`` and translates it; both are applied to the centres here
(a sphere is unchanged by a turn about its centre)."""
import numpy as np


def build(conf, s):
    rng = np.random.default_rng(conf["seed"])
    ground = s.lambertian((0.48, 0.83, 0.53))
    for i in range(20):
        for j in range(20):
            x0, z0 = -1000.0 + i * 100.0, -1000.0 + j * 100.0
            s.box((x0, 0.0, z0), (x0 + 100.0, rng.uniform(1.0, 101.0), z0 + 100.0), ground)
    s.quad((123.0, 554.0, 147.0), (300.0, 0.0, 0.0), (0.0, 0.0, 265.0), s.light((7.0, 7.0, 7.0)))
    s.sphere((400.0, 400.0, 200.0), 50.0, s.lambertian((0.7, 0.3, 0.1)),
             center2=(430.0, 400.0, 200.0))
    s.sphere((260.0, 150.0, 45.0), 50.0, s.dielectric(1.5))
    s.sphere((0.0, 150.0, 145.0), 50.0, s.metal((0.8, 0.8, 0.9), 1.0))
    s.sphere((360.0, 150.0, 145.0), 70.0, s.dielectric(1.5))
    s.constant_medium((360.0, 150.0, 145.0), 70.0, 0.2, (0.2, 0.4, 0.9))
    s.constant_medium((0.0, 0.0, 0.0), 5000.0, 1e-4, (1.0, 1.0, 1.0))
    s.sphere((400.0, 200.0, 400.0), 100.0, s.lambertian(s.image(conf["image"])))
    s.sphere((220.0, 280.0, 300.0), 80.0, s.lambertian(s.noise(0.2)))
    white = s.lambertian((0.73, 0.73, 0.73))
    cos_t, sin_t = np.cos(np.radians(15.0)), np.sin(np.radians(15.0))
    for _ in range(1000):
        x, y, z = rng.uniform(0.0, 165.0, 3)
        s.sphere((cos_t * x + sin_t * z - 100.0, y + 270.0, -sin_t * x + cos_t * z + 395.0),
                 10.0, white)
