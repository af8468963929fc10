"""Embedded decoder self-check fixture.

A tiny deterministic 64x48 baseline 4:2:0 JPEG (quality 85) plus the
sha256 of its BGR decode under the pinned-behavior configuration
(libjpeg ISLOW DCT + fancy upsampling) that the golden-parity contract
rides on (SURVEY.md §8bis item 3). io.jpeg verifies this digest once at
library load: if the system libjpeg(-turbo) ever changes decode
numerics, the mismatch surfaces as a clear error at import instead of
as silent reading drift. Regenerate only if the parity target itself
changes (see docs/parity.md).

The reference instead pinned its whole decode stack via
opencv-python==3.4.5.20 (/root/reference/requirements.txt:8); this is
the equivalent guard for a system-library dependency.
"""
import base64

CHECK_JPEG = base64.b64decode(
    "/9j/4AAQSkZJRgABAQAAAQABAAD/2wBDAAUDBAQEAwUEBAQFBQUGBwwIBwcHBw8LCwkM"
    "EQ8SEhEPERETFhwXExQaFRERGCEYGh0dHx8fExciJCIeJBweHx7/2wBDAQUFBQcGBw4I"
    "CA4eFBEUHh4eHh4eHh4eHh4eHh4eHh4eHh4eHh4eHh4eHh4eHh4eHh4eHh4eHh4eHh4e"
    "Hh4eHh7/wAARCAAwAEADASIAAhEBAxEB/8QAHwAAAQUBAQEBAQEAAAAAAAAAAAECAwQF"
    "BgcICQoL/8QAtRAAAgEDAwIEAwUFBAQAAAF9AQIDAAQRBRIhMUEGE1FhByJxFDKBkaEI"
    "I0KxwRVS0fAkM2JyggkKFhcYGRolJicoKSo0NTY3ODk6Q0RFRkdISUpTVFVWV1hZWmNk"
    "ZWZnaGlqc3R1dnd4eXqDhIWGh4iJipKTlJWWl5iZmqKjpKWmp6ipqrKztLW2t7i5usLD"
    "xMXGx8jJytLT1NXW19jZ2uHi4+Tl5ufo6erx8vP09fb3+Pn6/8QAHwEAAwEBAQEBAQEB"
    "AQAAAAAAAAECAwQFBgcICQoL/8QAtREAAgECBAQDBAcFBAQAAQJ3AAECAxEEBSExBhJB"
    "UQdhcRMiMoEIFEKRobHBCSMzUvAVYnLRChYkNOEl8RcYGRomJygpKjU2Nzg5OkNERUZH"
    "SElKU1RVVldYWVpjZGVmZ2hpanN0dXZ3eHl6goOEhYaHiImKkpOUlZaXmJmaoqOkpaan"
    "qKmqsrO0tba3uLm6wsPExcbHyMnK0t"
    "PU1dbX2Nna4uPk5ebn6Onq8vP09fb3+Pn6/9oA"
    "DAMBAAIRAxEAPwDb8AZk8M7gi58vg4OfXPf24rwj4uqw1wDYV28cgqev/wBYete++B1H"
    "/CM4HmbvLDDJ4Yc/h0xnPYGvDPivmXxARtbZvIwW3cHjJ/PNdnCtX2mPqU3K8m7bb69d"
    "LKzV3u7W3ufmvAOHtm9V2PUP2eijwIoVWEZC4Jww5656defTmtP47eW9oVCpKEU/MVP3"
    "j3z7k1T/AGfY82caMVK4XkZ4G3j6Z/z1rS+O/lx2ryCF1ZR/CeMfh07HHvXm4jEVI54/"
    "aONr6tp7K/ZNO1lo7p2tGz2+swOHX+sqt3POPgqwTW1VSqhmBAyeDkd+OnH/AOqvpvxX"
    "bSjwnk/eEeFAyMHt169Sc/rXzX8GkjTXIomjyA3cfd/I8c4/OvpvxYHTwozMcfKFH5d+"
    "/T0rj4wmvrcFX15Ulppy6Xd+m+i6eSsfdcSUP+Fajbuj5fuVQ+K9yRk7WySM8HHt1HXO"
    "fWvpnQtSOk/D6S6jDPO8Xk2525JPY9COBlueu3Gea+bpgV8TkKdpMmVwegBAxz/X8a9Z"
    "h1MX8SQReX5VkjRjAP3iRu6AdDgY/wBkkda6uI4Rr0qUZW5bJy0SWr2W99OjV7bPoen4"
    "v5r/AGNw9TqQdqkrRj3u1v8AJXfrZdSLwK6yeG1XdvAX7ysAc4x+Pb8uleCfFz5Nc2og"
    "3DjAHyjHUn8z/nmvfvApb/hG0J3AKgAx8oA6g4/PrXhHxgWP+2DnaoGVwFzjk/5zjvXd"
    "w/jJVMdXnze8m9dn02b0+bk/Ly/H/D/DWzepoep/s9QqygoQNoA+7kAYA9vr75rU+PSI"
    "9oVClsAj5gBkdSR9PpVL9neOEwJ5SnBQYGcFB7+mf61qfHbebMeaXaUNuC4HQd+K8udS"
    "H9syTS96TbcdYv3u70Telkk7votU/rcFh3/rMvU80+DQC667NvDFznPQj+WeR1r6b8Tx"
    "hvDPlmM4Cg5DcYAP9TzXzf8ABeINrsJUcZGRH/vYyf8A9R719NeJYi3hfMajDRHOVxkD"
    "GBx0OPT/ABrh4xpTeYUb63s+junvutbtq+ienfQ+64jor+1aPyPkXxtqa6TezXAZvtDO"
    "sUZC8eYe3pxgntnbivTfhdGq+GEwV80LgscE5Jxx74xXz98SLxNU+JTWqqBFZuYs9CJO"
    "j8kZ6jHccAivor4ZxMnhsA7dhjU4bj0/EdOn/wCqvq84wVTD5bSxFSGslur3S1cW76pr"
    "e+rTb6s/LPGzN1muIpUqb/d0vdXZv7T+b07NJM2/Akbf8Isitgh4+O/I+nXg/qK8L+K6"
    "x/2ywQMC8hUA9OPcdcA1754HQr4XUMWVRHhih68HnHp15/lXg/xcj2asxUgK7nBODwev"
    "f2PvXl8L1XRzKrJRvZO99Wtr9t3zK/d21SNuAMPfNqnqep/s7put0QliWOQcdeOpPfv6"
    "dT6VpfHeILCUfEm7sWyVOe4zz/LrVb9nvyRZIcgDHXHK44HH1/EVpfHcN/Zz5AG8gY4b"
    "3989vTtXm13T/tmzfM1rpqrNbO+muyfm7ax0+twNB/6zL1PN/g1Ht8QBIw2c7QVbIAOO"
    "f0FfQnxU1IaV8OpblD/pLReXGSoPznoeRjjDnng7fpXgHwVSNddAV2IRuADgjn3H1/ya"
    "9I+NmqLqNi1tFIFislMaDaAN5x5nbIORt7gbRzzV51GOKzalz25d2k1sukXor7xvu1o0"
    "tTs8Wc1/sZwqQdqk7Rj6vr8lr2vbufHMxH/CWNsMYzISTzyeT09Ofyr6v+F6M/h2NUOG"
    "WPczKM+pGMc/pXy3dhB4xKSE7EYEYAHA9D9ccH0r6r+GQiHhxTsO7AIy3XIBHPr9P8a+"
    "z42koYakpzVk7NarbXS3Na7WjWrSfXQ/H+KqF8FRsux//9k="
)

# sha256 of the expected [48, 64, 3] BGR u8 decode
CHECK_BGR_SHA256 = "345aa0cfac7cb2fa16900b9eb3ae1ea2fba5a58e6ee15d648f987f039fdf5691"
