"""The Next Week's Cornell box (``cornell_box``, case 7 of the book's
main()): five walls, a ceiling light and two axis-aligned blocks; the
room is open only at the front."""


def build(conf, s):
    red = s.lambertian((0.65, 0.05, 0.05))
    white = s.lambertian((0.73, 0.73, 0.73))
    green = s.lambertian((0.12, 0.45, 0.15))
    light = s.light((15.0, 15.0, 15.0))
    s.quad((555, 0, 0), (0, 555, 0), (0, 0, 555), green)
    s.quad((0, 0, 0), (0, 555, 0), (0, 0, 555), red)
    s.quad((343, 554, 332), (-130, 0, 0), (0, 0, -105), light)
    s.quad((0, 0, 0), (555, 0, 0), (0, 0, 555), white)
    s.quad((555, 555, 555), (-555, 0, 0), (0, 0, -555), white)
    s.quad((0, 0, 555), (555, 0, 0), (0, 555, 0), white)
    s.box((130, 0, 65), (295, 165, 230), white)
    s.box((265, 0, 295), (430, 330, 460), white)
